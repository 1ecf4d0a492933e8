from repro_torch.configs.base import GFLConfig

__all__ = ["GFLConfig"]
