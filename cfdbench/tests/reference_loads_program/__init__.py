"""A reference package that the harness has to refuse: it loads the
program it would judge (the harness's tests name it in a configuration
and expect the run to fail before the package is imported)."""

from ...reference import backends, case, engine  # noqa: F401
from ...reference import geometry, pressure  # noqa: F401
from tpufoam_torch.surrogate import pipeline  # noqa: F401
