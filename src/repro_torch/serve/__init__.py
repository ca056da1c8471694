from .engine import Completion, Request, ServingEngine  # noqa: F401
