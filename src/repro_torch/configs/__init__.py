from repro_torch.configs.base import GFLConfig, ModelConfig

__all__ = ["GFLConfig", "ModelConfig"]
