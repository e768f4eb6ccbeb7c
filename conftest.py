"""Session set-up shared by every test directory.

The JAX package's native runtime (`density_tpu/native/libdensity.so`) is
built in place by `density_tpu/native/build.py` on first use. Under
xdist every worker would build it at once and load the others'
half-written files, so the controller (or a lone process) builds it
once here, before any worker starts; a worker then finds it built and
up to date. `build.py` is loaded from its file, not through the
package, so no JAX is imported here.
"""

import importlib.util
import os
import subprocess

BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "density_tpu", "native", "build.py")


def pytest_configure(config):
    if hasattr(config, "workerinput") or not os.path.exists(BUILD):
        return
    spec = importlib.util.spec_from_file_location("_density_native_build",
                                                  BUILD)
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    try:
        build.build()
    except (OSError, subprocess.CalledProcessError):
        pass  # no toolchain: each worker's first load tries as before
