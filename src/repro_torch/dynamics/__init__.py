from repro_torch.dynamics.config import DynamicsConfig

__all__ = ["DynamicsConfig"]
