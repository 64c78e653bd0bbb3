"""Model zoo of the port: plain PyTorch functions over parameter dicts."""
from repro_torch.models.api import ModelAPI, get_model  # noqa: F401
