"""The port's fused producer + DP against the JAX package's, bit for bit.

``praline_tpu_torch.kernels.fused_dp.wavefront_dp_fused`` on CPU tensors
takes its plain version (the port's ``skewed_pair_scores`` then its plain
DP).  It is held against the three JAX functions the Hopper kernel
``csrc/fused_dp.cu`` replaces, on the same seeded numpy inputs:

- ``wavefront_dp_fused`` (Pallas, interpret mode) over modes x gap
  series, scores and traceback (JAX's band- and lane-padded ``tb`` cut
  to ``[D - 2, B, Lp]``; ``lengths=True`` so that it keeps its length
  carries);
- ``wavefront_dp_chunked`` (interpret mode, one band per chunk) with a
  long ``Ly``, its per-chunk traceback bytes joined;
- ``wavefront_dp_streamed``.

Tolerance 0.  The CUDA kernel is held against the plain version in
``test_torch_cuda.py``.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from praline_tpu import ALPHABET_AA, builtin_score_matrix
from praline_tpu.kernels.chunked import wavefront_dp_chunked as jax_chunked
from praline_tpu.kernels.fused_dp import wavefront_dp_fused as jax_fused
from praline_tpu.kernels.scan import wavefront_dp_streamed as jax_streamed
from praline_tpu_torch.kernels import fused_dp

torch.set_num_threads(1)

B62 = builtin_score_matrix("blosum62")
A = ALPHABET_AA.size
MODES = ["global", "semiglobal", "local"]
SERIES = [(11, 1), (13, 7, 1), (5,)]
TERMINALS = ("score", "length", "ti", "tj")


def seed_of(*key):
    return zlib.crc32(repr(key).encode())


def operands(seed, B, Lx, Ly):
    """Integer-count profiles with their inverses and ragged true lengths;
    problem 0 has lx = 1, problem 1 ly = 1 (the diagonal-1 terminals)."""
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 3, size=(B, Lx, A)).astype(np.float32)
    cy = rng.integers(0, 3, size=(B, Ly, A)).astype(np.float32)
    cx[:, :, 0] += 1
    cy[:, :, 0] += 1
    ivx = (np.float32(1.0) / cx.sum(axis=2)).astype(np.float32)
    ivy = (np.float32(1.0) / cy.sum(axis=2)).astype(np.float32)
    lx = rng.integers(max(1, Lx // 2), Lx + 1, size=B).astype(np.int32)
    ly = rng.integers(max(1, Ly // 2), Ly + 1, size=B).astype(np.int32)
    lx[0] = 1
    ly[min(1, B - 1)] = 1
    return cx, ivx, cy, ivy, B62.as_f32(), lx, ly


def port(ops, gap_series, mode, traceback):
    before = fused_dp.launches
    out = fused_dp.wavefront_dp_fused(*map(torch.from_numpy, ops), gap_series, mode, traceback)
    assert fused_dp.launches == before  # CPU tensors take the plain version
    return {k: v.numpy() for k, v in out.items()}


def assert_same(got, want, keys):
    for key in keys:
        assert np.array_equal(got[key], np.asarray(want[key])), key


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", SERIES)
@pytest.mark.parametrize("traceback", [False, True])
def test_plain_matches_jax_fused_kernel(mode, gap_series, traceback):
    """K5 in interpret mode; two 128-diagonal bands."""
    ops = operands(seed_of("fused", mode, gap_series), 2, 20, 115)
    want = jax_fused(*map(jnp.asarray, ops), gap_series=gap_series, mode=mode,
                     lengths=True, traceback=traceback, interpret=True)
    got = port(ops, gap_series, mode, traceback)
    keys = TERMINALS + (("tcode",) if traceback else ())
    assert_same(got, want, keys)
    if traceback:
        T, B, Lp = got["tb"].shape
        assert T == ops[0].shape[1] + ops[2].shape[1] - 1  # D - 2
        assert np.array_equal(got["tb"], np.asarray(want["tb"])[:T, :B, :Lp])


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax_chunked_route(mode):
    """K3's band window plus K4's chunk carries, one band per chunk:
    Ly = 330 against Lx = 60 gives four chunks."""
    ops = operands(seed_of("chunked", mode), 2, 60, 330)
    want = jax_chunked(*ops, gap_series=(11, 1), mode=mode, traceback=True,
                       chunk_bands=1, interpret=True)
    assert len(want["tb_chunks"]) == 4
    got = port(ops, (11, 1), mode, True)
    assert_same(got, want, TERMINALS + ("tcode",))
    T, B, Lp = got["tb"].shape
    tb = np.concatenate(want["tb_chunks"], axis=0)
    assert np.array_equal(got["tb"], tb[:T, :B, :Lp])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gap_series", [(11, 1), (13, 7, 1)])
def test_plain_matches_jax_streamed_scan(mode, gap_series):
    ops = operands(seed_of("streamed", mode, gap_series), 2, 20, 100)
    for traceback in (False, True):
        want = jax_streamed(*map(jnp.asarray, ops), gap_series=gap_series, mode=mode,
                            traceback=traceback)
        got = port(ops, gap_series, mode, traceback)
        assert set(got) == set(want)
        assert_same(got, want, list(want))


def test_lane_cap_is_the_kernels_block():
    assert fused_dp.MAX_LANES_FUSED == fused_dp.THREADS * fused_dp.LANES_PER_THREAD == 4096
    assert [fused_dp.padded_alphabet(a) for a in (4, 5, 23, 24, 32)] == [4, 8, 24, 24, 32]


def test_wrapper_refuses_modes_on_the_plain_path_too():
    ops = operands(seed_of("wrap"), 1, 5, 7)
    with pytest.raises(ValueError):
        port(ops, (11, 1), "diagonal", False)
