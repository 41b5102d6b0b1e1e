from .loader import default_config, load_config, merge_recursive

__all__ = ["default_config", "load_config", "merge_recursive"]
