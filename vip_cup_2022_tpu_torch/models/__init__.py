"""Model zoo of the port: importing it registers every ported family."""
from . import convnext, efficientnet, gcvit, resnet_rs  # noqa: F401
from .base import ModelConfig  # noqa: F401
from .factory import create_model, load_weights, transfer_weights  # noqa: F401
