"""Production mode is x32 (the JAX default); the rest of the suite enables
x64 globally, so run one end-to-end macau in a pristine x32 subprocess."""
import subprocess
import sys

SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
assert not jax.config.jax_enable_x64
import numpy as np
import bayesiandatafusion_jl_tpu as bdf
rng = np.random.default_rng(0)
U = rng.standard_normal((40, 3)); V = rng.standard_normal((30, 3))
R = U @ V.T + 0.1 * rng.standard_normal((40, 30))
mask = rng.random((40, 30)) < 0.5
df = bdf.IndexedDF(np.stack(np.nonzero(mask), 1), R[mask], (40, 30))
rd = bdf.RelationData.from_indexed_df(df)
rd.assign_to_test(0, 60)
res = bdf.macau(rd, num_latent=3, burnin=8, psamples=8, verbose=False,
                dtype="float32", gram_dtype="bfloat16")
assert np.isfinite(res["RMSE"]) and res["RMSE"] < 1.5, res["RMSE"]
print("X32OK", res["RMSE"])
"""


def test_macau_x32_subprocess():
    r = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                       text=True, timeout=300)
    assert "X32OK" in r.stdout, (r.stdout, r.stderr[-2000:])
