"""f-storage codec: optional bfloat16 HBM storage of the distributions.

The D3Q27 state is stored either as raw float32 f or as the well-known
shifted form g_k = f_k - w_k in bfloat16 ("FP16S"-style storage, public
technique: Lehmann et al. 2022, "Accuracy and performance of the lattice
Boltzmann method with 64-, 32-, and 16-bit floating-point arithmetic").
Subtracting the lattice weight removes the O(1) constant part so the
mantissa spends its bits on the O(u) deviation that carries the physics;
at rest g = 0 exactly.  All arithmetic stays float32 — only the HBM
resident arrays are bfloat16, halving the
dominant HBM traffic of the stream-collide step.

The Bouzidi correction's coefficients sum to 1 per link and opposite
directions share a weight (w[opp_k] = w[k]), so the correction is exactly
form-invariant in g-space and runs on encoded arrays unchanged.

This is what the reference's unused `precision` knob becomes here
(reference: src/config_loader.jl advanced.numerics; the reference itself
is float32-only, src/blocks.jl:118-150).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import lattice as lat

#: lattice weights broadcast over (27, X, Y, Z)
_W4 = lat.W.astype(np.float32).reshape(27, 1, 1, 1)

STORE_F32 = "float32"
STORE_BF16 = "bfloat16"

_ALIASES = {
    "float32": STORE_F32,
    "f32": STORE_F32,
    "single": STORE_F32,
    "bfloat16": STORE_BF16,
    "bf16": STORE_BF16,
}


def normalize_precision(precision: str) -> str:
    try:
        return _ALIASES[str(precision).lower()]
    except KeyError:
        raise ValueError(
            f"unsupported precision {precision!r}; use float32 or bfloat16"
        ) from None


def f_dtype(precision: str):
    return jnp.bfloat16 if normalize_precision(precision) == STORE_BF16 else jnp.float32


def encode_f(f: jnp.ndarray, precision: str) -> jnp.ndarray:
    """float32 f (27, X, Y, Z) -> stored representation."""
    if normalize_precision(precision) == STORE_BF16:
        return (f - jnp.asarray(_W4)).astype(jnp.bfloat16)
    return f


def decode_f(g: jnp.ndarray, k_axis: int = 0) -> jnp.ndarray:
    """Stored representation -> float32 f.  Dtype-dispatched so consumers
    need no precision plumbing; `k_axis` is the direction (27) axis."""
    if g.dtype == jnp.bfloat16:
        shape = [1] * g.ndim
        shape[k_axis] = 27
        w = jnp.asarray(_W4.reshape(27)).reshape(shape)
        return g.astype(jnp.float32) + w
    return g
