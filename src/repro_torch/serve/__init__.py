from .khi_service import KHIService, Request, Result, ServeConfig  # noqa: F401
