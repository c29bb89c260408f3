"""The three collision formulations agree: collide (the XLA step's stacked
(27, N) form), collide_unrolled_v2 (the factorized moment form, in f and in
g = f - w space) and collide_unrolled (the per-direction scalar form).

The moment form relies on exact lattice identities (discrete 2nd moment of
the 2nd-order equilibrium = rho(uu^T + cs^2 I); linearity of the sponge blend
and Guo forcing); this pins those identities against the per-direction form
on random states across all physics-flag combinations.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from open_ludwig import lattice as lat
from open_ludwig.ops import collide_math as cm


@pytest.mark.parametrize("wall_model", [False, True])
@pytest.mark.parametrize("sponge_blend", [False, True])
def test_collide_moments_matches_unrolled(wall_model, sponge_blend):
    rng = np.random.default_rng(11)
    S = (4, 8, 128)
    f = (lat.W[:, None, None, None]
         * (1 + 0.08 * rng.standard_normal((27,) + S))).astype(np.float32)
    nbrs = tuple(
        jnp.asarray(0.03 * rng.standard_normal((3,) + S).astype(np.float32))
        for _ in range(6)
    )
    obs = jnp.asarray(rng.random(S) < 0.1)
    sp = jnp.asarray((rng.random(S) * 0.5).astype(np.float32))
    wd = jnp.asarray(
        np.where(rng.random(S) < 0.3, rng.uniform(0.5, 5, S), 100.0
                 ).astype(np.float32)
    )
    kw = dict(tau=0.53, c_wale=0.2, nu_sgs_background=5e-4,
              wall_model=wall_model, sponge_blend=sponge_blend)
    u = jnp.float32(0.04)
    fl = [jnp.asarray(f[k]) for k in range(27)]
    a_f, a_r, a_v = cm.collide_unrolled(fl, nbrs, obs, sp, wd, u, **kw)
    w = [float(x) for x in lat.W]
    n = int(np.prod(S))
    stacked = cm.collide(
        jnp.asarray(f).reshape(27, n), tuple(v.reshape(3, n) for v in nbrs),
        obs.reshape(n), sp.reshape(n), wd.reshape(n), u, **kw,
    )
    results = {
        "collide": (stacked[0].reshape((27,) + S), stacked[1].reshape(S),
                    stacked[2].reshape((3,) + S)),
        "v2": cm.collide_unrolled_v2(fl, nbrs, obs, sp, wd, u, **kw),
    }
    g_f, g_r, g_v = cm.collide_unrolled_v2(
        [fl[k] - w[k] for k in range(27)], nbrs, obs, sp, wd, u,
        g_shifted=True, **kw,
    )
    results["v2 g-space"] = ([g_f[k] + w[k] for k in range(27)], g_r, g_v)
    for name, (b_f, b_r, b_v) in results.items():
        df = max(float(jnp.max(jnp.abs(a_f[k] - b_f[k]))) for k in range(27))
        assert df < 2e-6, (name, df)
        assert float(jnp.max(jnp.abs(a_r - b_r))) < 2e-6, name
        assert float(jnp.max(jnp.abs(a_v - b_v))) < 2e-6, name
