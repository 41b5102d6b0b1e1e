"""The evaluation layer: the chunked renderer, the image and pose metrics,
LPIPS and the ``Evaluator``.

Names resolve at first use: ``evaluator`` subclasses the ``Trainer``, which
imports ``render`` and ``metrics_pose`` from this package, so an eager import
here would be circular.
"""

import importlib

_EXPORTS = {
    "Evaluator": "evaluator", "init_positions": "evaluator",
    "ImageRenderer": "render",
    "exact_f32": "metrics_image", "lpips_fn": "metrics_image",
    "psnr": "metrics_image", "ssim": "metrics_image",
    "lpips": "lpips_torch", "load_weights": "lpips_torch",
    "default_weight_paths": "lpips_torch",
    "pose_error_report": "metrics_pose",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
