"""Sequential specification models and their packed/device forms."""

from .base import Inconsistent, Model, PackedModel, inconsistent
from .collections import (FIFOQueue, SetModel, UnorderedQueue, fifo_queue,
                          set_model, unordered_queue)
from .mutex import Mutex, mutex
from .registers import (CASRegister, MultiRegister, Register, cas_register,
                        multi_register, register)

__all__ = [
    "Inconsistent",
    "Model",
    "PackedModel",
    "inconsistent",
    "CASRegister",
    "MultiRegister",
    "Register",
    "cas_register",
    "multi_register",
    "register",
    "Mutex",
    "mutex",
    "FIFOQueue",
    "SetModel",
    "UnorderedQueue",
    "fifo_queue",
    "set_model",
    "unordered_queue",
]
