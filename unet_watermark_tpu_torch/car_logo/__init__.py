"""Car-logo dataset tooling (car_logo/ in the JAX package); the logo
downloader is not ported (it fetches from the network)."""
from .logo_placement import LogoPlacer
from .logo_process import remove_background_and_resize

__all__ = ["LogoPlacer", "remove_background_and_resize"]
