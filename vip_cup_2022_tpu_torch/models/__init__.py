"""Model zoo of the port: importing it registers every ported family."""
from . import aotnet, convnext, efficientnet, gcvit, nfnets, resnet_rs  # noqa: F401
from .base import ModelConfig  # noqa: F401
from .factory import (create_model, create_preprocessing, load_weights,  # noqa: F401
                      transfer_weights)
