from .engine import Engine, resolve_device
from .paged import PagedKVCache
from .scheduler import Scheduler, StepClock, WallClock
from .spec import Request, RequestResult, ServeSpec

__all__ = ["Engine", "PagedKVCache", "Request", "RequestResult", "Scheduler",
           "ServeSpec", "StepClock", "WallClock", "resolve_device"]
