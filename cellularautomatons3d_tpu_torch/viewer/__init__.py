from .server import serve, ViewerServer

__all__ = ["serve", "ViewerServer"]
