"""Version info (reference ReleaseVersion.txt, AMGX_get_api_version)."""

__version__ = "0.1.0"

# the reference API version the port tracks (ReleaseVersion.txt:1 ->
# 2.5.0), as the JAX package does
REFERENCE_API_VERSION = (2, 5)


def get_api_version():
    """(major, minor), as AMGX_get_api_version (amgx_c.h:160-163)."""
    return REFERENCE_API_VERSION
