"""The board compiler's routing parameters (``RouteConfig``).  The
reference's profile-guided optimizer over them (profile, optimize,
invariants) is not ported yet."""
from repro_torch.routeopt.config import RouteConfig

__all__ = ["RouteConfig"]
