"""The micro-probes' plain versions (tpuva_torch.probes) against the JAX
probes under bench/ (P1 repos_probe, P2 roll_probe, P3 i16_probe, P4
cell_probe), run in Pallas interpret mode on the CPU: one case each, bit
for bit (max abs error 0 on the uint8 or int32 tile), at the probe's own
tile shape and input.

The cases are collected from each JAX file's own main(), with its
bench_case / bench_pair / make_cascade / make replaced by a recorder, its
timeit by a stub that captures the input and the compilation cache
switched off; then each recorded body runs through the file's own
bench_case, bench_body, make_cascade or make at a few reps (140 for P2's
doubling cases, past float32 overflow; P4 with REPS = 3), its timeit
stubbed with a rising clock.
"""

import functools
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpuva.utils
from tpuva_torch.probes import cell_probe, i16_probe, repos_probe, roll_probe
from test_torch_kernels import one_torch_thread  # noqa: F401

BENCH = Path(__file__).resolve().parent.parent / "bench"
PROBES = {"repos_probe": (repos_probe, "bench_case"), "roll_probe": (roll_probe, "bench_pair"),
          "i16_probe": (i16_probe, "make_cascade"), "cell_probe": (cell_probe, "make")}
# P2's cases whose values double each rep: inf (output 255) after ~128 reps
DOUBLING = ("add f+f", "roll0 + add", "roll1 + add", "slice1+add (unaligned)")


def load_bench(name):
    spec = importlib.util.spec_from_file_location(f"bench_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stub_timeit(captured):
    """A timeit that calls fn once, keeps (input, output) and returns a
    rising clock (bench_case divides by t2 - t1)."""
    clock = itertools.count(1)

    def timeit(fn, args, **_kw):
        out = fn(*args)
        captured.append((np.asarray(args[0]), None if out is None else np.asarray(out)))
        return float(next(clock)), out

    return timeit


@functools.lru_cache(maxsize=None)
def recorded(name):
    """(the JAX module, [(args, kwargs) of each case's call in main()],
    [main()'s inputs to timeit])."""
    mod = load_bench(name)
    hook = PROBES[name][1]
    calls, inputs = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpuva.utils, "enable_compilation_cache", lambda *a, **k: None)
        mp.setattr(mod, hook, lambda *a, **k: calls.append((a, k)) or (lambda *x: None))
        mp.setattr(mod, "timeit", stub_timeit(inputs))
        mod.main()
    return mod, calls, inputs


def jax_outputs(name, i):
    """[(reps, input, the JAX probe's output)] of case i of bench/<name>.py."""
    mod, calls, inputs = recorded(name)
    args, kw = calls[i]
    captured = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "timeit", stub_timeit(captured))
        if name == "repos_probe":
            mod.bench_case(*args, **dict(kw, r1=1, r2=3))
            return [(r, x, out) for r, (x, out) in zip((1, 3), captured)]
        if name == "roll_probe":
            pair_name, body, sh, sw, _n_ops = args
            reps = (1, 3, 140) if pair_name in DOUBLING else (1, 3)
            for r in reps:
                mod.bench_body(pair_name, body, sh, sw, r, _n_ops)
            return [(r, x, out) for r, (x, out) in zip(reps, captured)]
        x = inputs[i][0]
        if name == "i16_probe":
            dtype, sh, sw, _reps = args
            return [(r, x, np.asarray(mod.make_cascade(dtype, sh, sw, r)(jnp.asarray(x))))
                    for r in (1, 3)]
        mp.setattr(mod, "REPS", 3)
        return [(3, x, np.asarray(mod.make(args[0])(jnp.asarray(x))))]


def recorded_case(name, i):
    """(name, n_ops) of case i as the JAX file's main() spells it."""
    args = recorded(name)[1][i][0]
    if name == "repos_probe":
        return args[0], args[2]
    if name == "roll_probe":
        return args[0], args[4]
    if name == "i16_probe":
        return jnp.dtype(args[0]).name, None
    return args[0], None


@pytest.mark.parametrize("name, i", [(n, i) for n, (mod, _h) in PROBES.items()
                                     for i in range(len(mod.CASES))])
def test_probe_plain_matches_jax(name, i):
    port = PROBES[name][0]
    assert len(recorded(name)[1]) == len(port.CASES)
    case = port.CASES[i]
    jax_name, jax_n_ops = recorded_case(name, i)
    assert case.name == jax_name
    assert jax_n_ops in (None, case.n_ops)
    results = jax_outputs(name, i)
    assert results
    for reps, x, want in results:
        x, want = x.copy(), want.copy()
        assert torch.equal(torch.from_numpy(x), port.make_tile())  # the file's own input
        got = port.plain(torch.from_numpy(x), case.name, reps)
        assert got.shape == want.shape and got.dtype == torch.from_numpy(want).dtype
        err = int((got.to(torch.int64) - torch.from_numpy(want).to(torch.int64)).abs().max())
        assert err == 0, f"{name} {case.name} at {reps} reps: max abs err {err}"
        assert torch.equal(port.run(torch.from_numpy(x), case.name, reps), got)
        if name == "roll_probe" and reps == 140:
            assert (got == 255).any(), "past float32 overflow the output saturates to 255"
        if name == "i16_probe" and case.name == "int16" and reps > 1:
            # the column pass wraps; the rescale's signed high byte then
            # feeds the next rep
            wide = port.plain(torch.from_numpy(x), "int32", reps)
            assert not torch.equal(got, wide), "the int16 cascade wraps"


def test_run_rejects_what_the_kernel_does_not_take():
    x = roll_probe.make_tile()
    with pytest.raises(ValueError, match="unknown case"):
        roll_probe.run(x, "roll axis2", 1)
    with pytest.raises(ValueError, match=r"\(112, 1152\)"):
        roll_probe.run(x[:, :64], "add f+f", 1)
    with pytest.raises(ValueError, match="int32"):
        cell_probe.run(cell_probe.make_tile().to(torch.int64), "baseline_min", 1)
