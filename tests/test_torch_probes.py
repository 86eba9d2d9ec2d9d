"""The port's roofline and write probes (K7, K8, K9) on the CPU.

``praline_tpu_torch.kernels.probes`` on CPU tensors takes the plain
versions, which are held bit for bit against the TPU kernels' own text,
run through ``pl.pallas_call(..., interpret=True)`` at tiny sizes:

- K7 ``run_vmem`` and K8 ``run_alu`` are closures inside the root
  ``bench.py::bench_utilization``; each is rebuilt from that function's
  code object with its free variables (``CHAIN``, ``STEPS``, ``NACC``,
  ``ACH``, ``ASTEPS``, the array sizes, ``jnp``, ``np``, ``pl``, ``jax``)
  bound to tiny values through ``types.CellType``, so the test runs
  ``bench.py``'s kernels and ``pallas_call`` as written;
- K9 ``make_writer`` is compiled from the text of
  ``tools/onchip_wprobe.py`` (that module asserts a TPU when imported, so
  it is not imported) with tiny sizes and a ``pl`` whose ``pallas_call``
  runs in interpret mode.

Inputs are numpy-seeded and take both arms of the ``max`` (``v - 1.0``
wins above 1000), negatives and a start near 1e-36.  Tolerance 0.  The
CUDA kernels are held against the plain versions in ``test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench as root_bench
from praline_tpu_torch.kernels import probes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def bench_closure(name: str, env: dict):
    """The function ``name`` defined inside ``bench.py::bench_utilization``,
    with its free variables bound from ``env``."""
    code = next(c for c in root_bench.bench_utilization.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    cells = tuple(types.CellType(env[v]) for v in code.co_freevars)
    return types.FunctionType(code, root_bench.__dict__, name, None, cells)


def jax_env(**sizes) -> dict:
    return dict(sizes, jax=jax, jnp=jnp, np=np, pl=pl, pltpu=pltpu, interp=True)


def jax_run_vmem(x: np.ndarray, chain: int, steps: int) -> np.ndarray:
    env = jax_env(CHAIN=chain, STEPS=steps, R=x.shape[0], C=x.shape[1])
    env["vmem_kernel"] = bench_closure("vmem_kernel", env)
    return np.asarray(jax.jit(bench_closure("run_vmem", env))(jnp.asarray(x)))


def jax_run_alu(x: np.ndarray, ach: int, asteps: int) -> np.ndarray:
    env = jax_env(NACC=probes.NACC, ACH=ach, ASTEPS=asteps, AR=x.shape[0], AC=x.shape[1])
    env["alu_kernel"] = bench_closure("alu_kernel", env)
    return np.asarray(jax.jit(bench_closure("run_alu", env))(jnp.asarray(x)))


@functools.lru_cache(maxsize=None)
def jax_make_writer(Bs: int, rows: int, lp: int, pb: int, tile: int):
    """``tools/onchip_wprobe.py::make_writer`` compiled from the file's text
    with the module constants ``Bs``, ``ROWS``, ``LP``, ``PB``, ``TILE``."""
    tree = ast.parse((ROOT / "tools" / "onchip_wprobe.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_writer")
    interpreted = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, pallas_call=functools.partial(pl.pallas_call, interpret=True))
    ns = dict(Bs=Bs, ROWS=rows, LP=lp, PB=pb, TILE=tile, jax=jax, jnp=jnp, pl=interpreted,
              pltpu=pltpu)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "tools/onchip_wprobe.py", "exec"), ns)
    return ns["make_writer"]


def chain_inputs(seed: int, shape) -> np.ndarray:
    """Values on both arms of the max: above 1000 (``v - 1.0`` wins),
    ordinary magnitudes of both signs, tiny ones near 1e-36, zeros."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, size=shape).astype(np.float32)
    flat = x.reshape(-1)
    n = flat.size
    flat[: n // 4] = rng.uniform(900.0, 5000.0, size=n // 4)
    flat[n // 4 : n // 4 + 8] = [1e-36, -1e-36, 3e-36, 0.0, -0.0, 1000.0, 999.5, -1e30]
    rng.shuffle(flat)
    return x


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


@pytest.mark.parametrize("shape,chain,steps", [((8, 128), 5, 3), ((16, 128), 64, 2),
                                               ((8, 256), 1, 7)])
def test_smem_chain_plain_matches_bench_vmem_kernel(shape, chain, steps):
    x = chain_inputs(chain * 100 + steps, shape)
    want = jax_run_vmem(x, chain, steps)
    before = dict(probes.launches)
    got = probes.smem_chain(torch.from_numpy(x), chain * steps)
    assert probes.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(bits(got), bits(want))
    # both arms of the max were taken
    assert (x > 1000).any() and (x > 0).any() and (x < 0).any()


# ASTEPS >= 2, as on the TPU (131072): with one trip XLA drops the loop and
# its simplifier refactors x*a + x*b into x*(a + b), another arithmetic.
# NACC is 4 in both kernels.
@pytest.mark.parametrize("ach,asteps", [(3, 5), (2, 3), (7, 2), (4, 2)])
def test_alu_chains_plain_matches_bench_alu_kernel(ach, asteps):
    x = chain_inputs(ach * 10 + asteps, (8, 128))
    want = jax_run_alu(x, ach, asteps)
    got = probes.alu_chains(torch.from_numpy(x), ach * asteps)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("lane_tiles,pb", [(1, 2), (2, 1), (2, 4)])
@pytest.mark.parametrize("value", [3.5, -0.0, -1e-36, 1e30])
def test_write_blocks_plain_matches_wprobe_writer(lane_tiles, pb, value):
    Bs, rows, lp, tile = 4, 256, 256, 128
    writer = jax_make_writer(Bs, rows, lp, pb, tile)(lane_tiles, pb=pb)
    x = np.array([[value]], np.float32)
    want = np.asarray(writer(jnp.asarray(x)))
    got = probes.write_blocks(torch.from_numpy(x), (Bs, rows, lp), (pb, tile, lane_tiles * tile))
    assert got.shape == want.shape
    np.testing.assert_array_equal(bits(got), bits(want))


def test_write_blocks_fills_a_strided_view_of_hs():
    """The producer's pattern: every element of ``hs f32[D, B, Lp]``
    through its ``[B, D, Lp]`` view, ragged blocks at the edges."""
    hs = torch.full((37, 3, 20), 7.0)
    x = torch.tensor([[-2.5]])
    out = probes.write_blocks(x, block=probes.HS_BLOCK, out=probes.hs_pattern_view(hs))
    assert out.data_ptr() == hs.data_ptr()
    assert torch.equal(hs, torch.full((37, 3, 20), -2.5))


def test_plain_versions_repeat_the_arithmetic():
    """The plain versions against a numpy restatement of the per-element
    arithmetic (f32 rounding at every step)."""
    x = chain_inputs(3, (4, 64))
    links = 40
    v = np.stack([x * np.float32(1.0 + 0.125 * c) for c in range(4)])
    for _ in range(links):
        v = np.maximum(v * np.float32(0.999), v - np.float32(1.0))
    want = ((v[0] + v[1]) + v[2]) + v[3]
    np.testing.assert_array_equal(bits(probes.alu_chains(torch.from_numpy(x), links)),
                                  bits(want))
    np.testing.assert_array_equal(bits(probes.smem_chain(torch.from_numpy(x), links)),
                                  bits(v[0]))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.ones(4, 4)
    with pytest.raises(ValueError, match="links"):
        probes.alu_chains(x, -1)
    with pytest.raises(ValueError, match="links"):
        probes.smem_chain(x, -1)
    with pytest.raises(ValueError, match="block"):
        probes.write_blocks(x, (2, 2, 2), (0, 1, 1))
    with pytest.raises(ValueError, match="3-d"):
        probes.write_blocks(x, (2, 2))
    probes.reset_launches()
    assert probes.launches == {"alu_chains": 0, "smem_chain": 0, "write_blocks": 0}


def test_write_blocks_checks_its_arguments_and_writes_only_the_view():
    """The wrapper's checks, and its plain version on an unaligned strided
    view: every element of the view becomes ``x[0, 0]`` (-0.0 stays -0.0),
    nothing around it changes."""
    one = torch.ones(1, 1)
    with pytest.raises(ValueError, match="f32"):
        probes.write_blocks(torch.ones(1, 1, dtype=torch.float64), (2, 2, 2))
    with pytest.raises(ValueError, match="non-empty"):
        probes.write_blocks(torch.ones(0), (2, 2, 2))
    with pytest.raises(ValueError, match="3-d"):
        probes.write_blocks(one, out=torch.empty(2, 2, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="block"):
        probes.write_blocks(one, (2, 2, 2), (2, 2))
    base = torch.full((7, 30, 51), float("nan"))
    view = base[1:6, 2:29, 3:50]
    assert view.data_ptr() % 16 != 0 and view.stride() == (1530, 51, 1)
    assert probes.write_blocks(torch.tensor([[-0.0]]), block=(2, 7, 11), out=view) is view
    inside = torch.zeros(base.shape, dtype=torch.bool)
    inside[1:6, 2:29, 3:50] = True
    assert torch.equal(base[inside].view(torch.int32),
                       torch.full((5 * 27 * 47,), -0.0).view(torch.int32))
    assert bool(base[~inside].isnan().all())
    assert probes.launches["write_blocks"] == 0
