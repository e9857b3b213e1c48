"""Training-side pieces the serving slice needs: the precision policy."""

from .policy import Policy, make_policy

__all__ = ["Policy", "make_policy"]
