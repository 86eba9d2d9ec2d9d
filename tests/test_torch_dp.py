"""The port's wavefront DP against the JAX package's, bit for bit.

The plain PyTorch DP (``praline_tpu_torch.kernels.scan``) is held against
``praline_tpu.kernels.scan.wavefront_dp`` over modes x gap series, every
terminal and every traceback byte; and against the Pallas kernels
``wavefront_dp_pallas`` and ``wavefront_dp_strip`` (interpret mode) on the
same seeded inputs.  Tolerance 0.  The CUDA kernel is held against the
plain version in ``test_torch_cuda.py``.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels.pallas_dp import wavefront_dp_pallas
from praline_tpu.kernels.scan import wavefront_dp as jax_dp
from praline_tpu.kernels.scores import skewed_pair_scores as jax_skewed
from praline_tpu.kernels.strip import strip_dispatch_core, strip_stride
from praline_tpu_torch.kernels import wavefront
from praline_tpu_torch.kernels.scan import wavefront_dp

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
A = ALPHABET_AA.size
MODES = ["global", "semiglobal", "local"]
SERIES = [(11, 1), (13, 7, 1), (5,)]
KEYS = ("score", "length", "ti", "tj", "tcode")


def workload(seed, B=8, bx=31, by=63):
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 3, size=(B, bx, A)).astype(np.float32)
    cy = rng.integers(0, 3, size=(B, by, A)).astype(np.float32)
    cx[:, :, 0] += 1
    cy[:, :, 0] += 1
    ivx = (np.float32(1.0) / cx.sum(axis=2)).astype(np.float32)
    ivy = (np.float32(1.0) / cy.sum(axis=2)).astype(np.float32)
    lx = rng.integers(1, bx + 1, size=B).astype(np.int32)
    ly = rng.integers(1, by + 1, size=B).astype(np.int32)
    lx[0], ly[0] = 1, 1  # the length-1 border candidates
    hs = np.array(jax_skewed(cx, ivx, cy, ivy, B62.as_f32()))  # writable copy
    return cx, ivx, cy, ivy, lx, ly, hs


def port(hs, lx, ly, gap_series, mode, traceback):
    out = wavefront_dp(torch.from_numpy(hs), torch.from_numpy(lx), torch.from_numpy(ly),
                       gap_series, mode, traceback)
    return {k: v.numpy() for k, v in out.items()}


def seed_of(*key):
    return zlib.crc32(repr(key).encode())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", SERIES)
@pytest.mark.parametrize("traceback", [False, True])
def test_plain_matches_jax_scan(mode, gap_series, traceback):
    _, _, _, _, lx, ly, hs = workload(seed_of("scan", mode, gap_series))
    want = jax_dp(jnp.asarray(hs), jnp.asarray(lx), jnp.asarray(ly),
                  gap_series=gap_series, mode=mode, traceback=traceback)
    got = port(hs, lx, ly, gap_series, mode, traceback)
    assert set(got) == set(want)
    for key in got:
        assert np.array_equal(got[key], np.asarray(want[key])), key


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", SERIES)
def test_plain_matches_pallas_classic(mode, gap_series):
    """K4 in interpret mode, traceback and length carries on."""
    _, _, _, _, lx, ly, hs = workload(seed_of("pallas", mode, gap_series), B=4, by=31)
    want = wavefront_dp_pallas(jnp.asarray(hs), jnp.asarray(lx), jnp.asarray(ly),
                               gap_series=gap_series, mode=mode, traceback=True,
                               lengths=True, interpret=True)
    got = port(hs, lx, ly, gap_series, mode, True)
    for key in KEYS + ("tb",):
        assert np.array_equal(got[key], np.asarray(want[key])), key


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1)])
def test_plain_matches_pallas_strip(mode, gap_series):
    """K1 + K2 in interpret mode (strip producer and strip DP, R = 4
    problems per row) against the port's producer and plain DP."""
    B, bx, by, R = 8, 31, 31, 4
    cx, ivx, cy, ivy, lx, ly, hs = workload(seed_of("strip", mode, gap_series), B, bx, by)
    want = strip_dispatch_core(
        jnp.asarray(cx), jnp.asarray(ivx), jnp.asarray(cy), jnp.asarray(ivy),
        jnp.asarray(B62.as_f32()), jnp.asarray(lx), jnp.asarray(ly),
        K=strip_stride(bx, by), R=R, gap_series=gap_series, mode=mode, qd=None,
        interpret=True,
    )
    got = port(hs, lx, ly, gap_series, mode, False)
    for key in ("score", "length", "ti", "tj"):
        assert np.array_equal(got[key], np.asarray(want[key]).reshape(B)), key


def test_deep_series_and_k1_traceback():
    """A deep gap series (k = 6) and the single-level one (k = 1)."""
    _, _, _, _, lx, ly, hs = workload(seed_of("deep"), B=4, bx=31, by=31)
    for gap_series in [(9, 7, 5, 3, 2, 1), (4,)]:
        for mode in MODES:
            want = jax_dp(jnp.asarray(hs), jnp.asarray(lx), jnp.asarray(ly),
                          gap_series=gap_series, mode=mode, traceback=True)
            got = port(hs, lx, ly, gap_series, mode, True)
            for key in got:
                assert np.array_equal(got[key], np.asarray(want[key])), (gap_series, mode, key)


def test_wrapper_takes_plain_path_on_cpu_and_checks_modes():
    _, _, _, _, lx, ly, hs = workload(seed_of("wrap"), B=2, bx=31, by=31)
    before = wavefront.launches
    out = wavefront.wavefront_dp(torch.from_numpy(hs), torch.from_numpy(lx),
                                 torch.from_numpy(ly), (11, 1), "global")
    assert wavefront.launches == before
    want = port(hs, lx, ly, (11, 1), "global", False)
    assert all(np.array_equal(out[k].numpy(), want[k]) for k in KEYS)
    with pytest.raises(ValueError):
        wavefront_dp(torch.from_numpy(hs), torch.from_numpy(lx), torch.from_numpy(ly),
                     (11, 1), "diagonal")

