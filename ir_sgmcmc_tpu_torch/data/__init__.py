from .synthetic import sphere, sphere_pair

__all__ = ["sphere", "sphere_pair"]
