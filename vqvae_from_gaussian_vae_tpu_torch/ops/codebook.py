"""The fixed Gaussian codebook: 2^16 scrambled-Sobol normal draws.

A numpy/scipy copy of the JAX package's ``ops/codebook.py`` (the port may
not import that package).  Checkpoints do not store the codebook, so token
indices are portable only if every implementation regenerates the identical
table from (n_samples, group, seed): torch's scrambled ``SobolEngine``
(JoeKuo-D6 direction numbers, MAXBIT=30, digital shift plus a lower
triangular matrix scramble drawn from one MT19937 stream, Gray-code draw)
pushed through the inverse normal CDF in float64 and cast to float32.

``prior_samples`` loads the shipped ``assets/prior_samples_n*_g*_s*.npy``
table when present and otherwise generates it.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.stats import norm

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
)

MAXBIT = 30  # torch SobolEngine.MAXBIT
_SOBOL_STATE_DIMS = 256

# (n, g, seed) -> table; the table is read-only once cached
_CACHE: dict = {}


def _asset_path(n_samples: int, n_variable: int, seed: int) -> str:
    return os.path.join(_ASSET_DIR, f"prior_samples_n{n_samples}_g{n_variable}_s{seed}.npy")


def _sobol_state(n_variable: int) -> np.ndarray:
    """Unscrambled (n_variable, MAXBIT) int64 direction-number state."""
    if n_variable > _SOBOL_STATE_DIMS:
        raise ValueError(
            f"shipped Sobol direction numbers cover <= {_SOBOL_STATE_DIMS} dims, "
            f"got {n_variable}"
        )
    state = np.load(os.path.join(_ASSET_DIR, "sobol_state_d256.npy"))
    return state[:n_variable]


def _scramble(state: np.ndarray, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """torch SobolEngine._scramble: returns (scrambled_state, shift)."""
    dim = state.shape[0]
    rs = np.random.RandomState(seed)
    # torch draws shift bits first, then LMS bits, from one MT19937 stream
    shift_bits = (
        rs.randint(0, 2**32, size=dim * MAXBIT, dtype=np.uint32).astype(np.int64) % 2
    ).reshape(dim, MAXBIT)
    shift = shift_bits @ (1 << np.arange(MAXBIT, dtype=np.int64))
    ltm = (
        rs.randint(0, 2**32, size=dim * MAXBIT * MAXBIT, dtype=np.uint32).astype(np.int64)
        .reshape(dim, MAXBIT, MAXBIT) % 2
    )
    ltm = np.tril(ltm)
    idx = np.arange(MAXBIT)
    ltm[:, idx, idx] = 1  # unit diagonal keeps the scramble invertible
    # state bits MSB-first: B[d, j, c] = bit (MAXBIT-1-c) of state[d, j]
    bits = (state[:, :, None] >> (MAXBIT - 1 - idx)[None, None, :]) & 1
    # scrambled bit p of word j in dim d = <L[d, p, :], B[d, j, :]> mod 2
    mixed = np.einsum("dpc,djc->djp", ltm, bits) % 2
    scrambled = (mixed * (1 << (MAXBIT - 1 - idx))[None, None, :]).sum(-1)
    return scrambled.astype(np.int64), shift.astype(np.int64)


def _draw(state: np.ndarray, shift: np.ndarray, n: int) -> np.ndarray:
    """Gray-code Sobol draw: (n, dim) float32 in [0, 1), torch-bit-exact."""
    dim = state.shape[0]
    rows = np.empty((n, dim), dtype=np.int64)
    rows[0] = shift
    if n > 1:
        i = np.arange(n - 1, dtype=np.int64)
        # rightmost_zero(i) = trailing ones of i = trailing zeros of i+1
        lsb = (i + 1) & -(i + 1)
        level = np.log2(lsb.astype(np.float64)).astype(np.int64)
        rows[1:] = shift[None, :] ^ np.bitwise_xor.accumulate(state[:, level].T, axis=0)
    return rows.astype(np.float32) * np.float32(2.0 ** -MAXBIT)


def generate(n_samples: int, n_variable: int, seed: int) -> np.ndarray:
    """Generate the (n_samples, n_variable) float32 codebook in numpy."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must be a 32-bit unsigned int, got {seed}")
    scrambled, shift = _scramble(_sobol_state(n_variable), seed)
    u = _draw(scrambled, shift, n_samples)
    return norm.ppf(u).astype(np.float32)  # ppf in float64, then float32


def prior_samples(n_samples: int, n_variable: int, seed: int = 42) -> np.ndarray:
    """Return the (n_samples, n_variable) float32 codebook: the shipped asset
    when there is one, else a freshly generated table (not written back)."""
    key = (n_samples, n_variable, seed)
    if key not in _CACHE:
        path = _asset_path(n_samples, n_variable, seed)
        table = np.load(path) if os.path.exists(path) else generate(*key)
        table = np.ascontiguousarray(table, dtype=np.float32)
        table.setflags(write=False)
        _CACHE[key] = table
    return _CACHE[key]


def standard_normal_log_prob(codebook: np.ndarray) -> np.ndarray:
    """log N(c; 0, 1) of each entry, float32: the prior term of the search
    score."""
    c = codebook.astype(np.float32)
    return (-0.5 * c * c - 0.5 * np.log(2.0 * np.pi).astype(np.float32)).astype(np.float32)
