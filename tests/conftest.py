import os

# The tests run on the CPU, on a virtual 8-device mesh.  jax.config is set
# here (it wins over the environment), so no test reaches a GPU; the GPU is
# exercised by chip_smoke.py and bench.py.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
