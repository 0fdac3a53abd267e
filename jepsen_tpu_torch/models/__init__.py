"""Sequential specification models and their packed/device forms."""

from .base import Model, PackedModel
from .registers import CASRegister, Register, cas_register, register

__all__ = [
    "Model",
    "PackedModel",
    "CASRegister",
    "Register",
    "cas_register",
    "register",
]
