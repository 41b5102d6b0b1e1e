from .exchange import load_jax_params, params_from_jax, params_to_jax
from .fields import (ColorConfig, ColorNetwork, MotionConfig, MotionNetwork,
                     NeRF, NerfConfig, SDFConfig, SDFNetwork, VarianceConfig,
                     VarianceNetwork, configs_from_cfg, init_all_fields)

__all__ = [
    "ColorConfig", "ColorNetwork", "MotionConfig", "MotionNetwork", "NeRF",
    "NerfConfig", "SDFConfig", "SDFNetwork", "VarianceConfig",
    "VarianceNetwork", "configs_from_cfg", "init_all_fields",
    "load_jax_params", "params_from_jax", "params_to_jax",
]
