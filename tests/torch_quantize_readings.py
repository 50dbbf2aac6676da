"""Readings behind the whole-graph bound of ``test_torch_quantize_modes.py``.

For each graph of that test (width-16 HRNet and small CPN, "static" and
"c128", 64x64, fp32) and each of 3 draws of the random weights x 6 draws of
the input, the port's maps from the JAX package's prepared variables
against the JAX package's served (``jit``) maps: the largest relative RMS
over the four levels, and how many draws part by more than 1e-5 (an int8
rounding crossing carried on by the chained convs).

    JAX_PLATFORMS=cpu python tests/torch_quantize_readings.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_quantize_modes as T  # noqa: E402

WEIGHT_SEEDS = (3, 4, 7)
INPUT_DRAWS = 6
CROSSED = 1e-5


def graph(kind, mode, seed):
    """The test fixture's graph with its weights drawn from ``seed``."""
    cfg, jcfg = T._configs(kind, mode)
    rng = np.random.RandomState(seed)
    calib = rng.randn(2, *T.HW, 3).astype(np.float32)
    jmodel = (T.JHRNet if kind == "hrnet" else T.JCPN)(cfg=jcfg,
                                                       dtype=jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *T.HW, 3)))
    params = T._random_params(shapes["params"], rng)
    variables = {"params": params}
    if mode == "static":
        _, upd = jax.jit(jmodel.apply, static_argnames="mutable")(
            variables, calib, mutable=("calib",))
        variables["calib"] = T._np(upd["calib"])
    q_shapes = jax.eval_shape(
        lambda v, x: jmodel.apply(v, x, mutable=["qweights"]), variables,
        jnp.zeros((1, *T.HW, 3)))[1]["qweights"]
    variables["qweights"] = T._jax_qweights(params, q_shapes)
    return dict(kind=kind, cfg=cfg, params=params, variables=variables,
                apply=jax.jit(jmodel.apply))


def main():
    for kind, mode in T.CASES:
        readings = []
        for seed in WEIGHT_SEEDS:
            g = graph(kind, mode, seed)
            model = T._port(g, g["variables"])
            for draw in range(INPUT_DRAWS):
                x = np.random.RandomState(100 + draw).randn(
                    2, *T.HW, 3).astype(np.float32)
                theirs = g["apply"](g["variables"], x)
                readings.append(max(
                    T._rel_rms(a, np.asarray(b))
                    for a, b in zip(T._maps(model, x), theirs)))
        r = np.asarray(readings)
        crossed = r > CROSSED
        print(f"{kind} {mode}: {len(r)} draws, {int(crossed.sum())} crossed;"
              f" largest relative RMS a level {r.max():.3e}, largest where"
              f" none crossed {r[~crossed].max() if (~crossed).any() else 0:.3e}",
              flush=True)


if __name__ == "__main__":
    main()
