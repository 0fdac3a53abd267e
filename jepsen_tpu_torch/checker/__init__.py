"""Checkers: the stock history checkers, the linearizable checker and
its exact CPU engines."""

from .core import (Checker, Compose, CounterChecker, LogFilePattern, NoOp,
                   Queue, SetChecker, SetFull, Stats, TotalQueue,
                   UnhandledExceptions, UniqueIds, check_safe, checker,
                   compose, concurrency_limit, merge_valid, valid_rank)
from .linearizable import Linearizable, linearizable
from .wgl_cpu import WGLResult, check_wgl_cpu, check_wgl_host_model

__all__ = ["Checker", "Compose", "CounterChecker", "Linearizable",
           "LogFilePattern", "NoOp", "Queue", "SetChecker", "SetFull",
           "Stats", "TotalQueue", "UnhandledExceptions", "UniqueIds",
           "WGLResult", "check_safe", "check_wgl_cpu",
           "check_wgl_host_model", "checker", "compose",
           "concurrency_limit", "linearizable", "merge_valid",
           "valid_rank"]
