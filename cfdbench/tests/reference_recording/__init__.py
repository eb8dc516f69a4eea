"""A reference package for the harness's tests, made as a configuration's
own reference is: the frozen modules re-exported, and as files of its own
the two it changes, `pipeline` and `geometry`, whose factories record the
keyword arguments of each call (`calls`) and pass them on."""

from ...reference import backends, case, engine, pressure  # noqa: F401
from . import geometry, pipeline  # noqa: F401
