"""Prove that the engine runs on one NVIDIA GPU through its public entry points.

Run from the root of a checkout, on a machine with a GPU::

    python chip_smoke.py                 # one GPU, every phase
    python chip_smoke.py --four-gpus     # the distributed engine on 4 GPUs
    python chip_smoke.py --phase dgemm --phase kernels   # a subset

Phases (one GPU, in order): ``env``, ``gpu_tests`` (the ``gpu``-marked
tests, in this process), ``dgemm`` (16384^3 against cuBLAS DGEMM, 4096^3
against the long-double oracle; the compiled peak memory of 16384^3
``fp64_int8_18`` and of AUTO under the interceptor against the card's
limit), ``identity`` (GPU results bitwise equal
to the same calls on the CPU device), ``zgemm``, ``intercept`` (the
``jnp.dot`` interceptor and ``traced.gemm`` under ``jit``), ``hpl`` (the
device-resident LU solve) and ``kernels`` (how XLA lowered the engine's
int8 dots, and warm times of its pieces beside a plain int8 matmul and a
large copy — findings, not gates).  ``--four-gpus`` runs only the mesh
variants, each compared bitwise with the single-GPU engine.

Every phase prints what it checked.  A phase that fails is reported and
the script exits non-zero without a result line; otherwise the last
stdout line is ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": N}}``.  Without a GPU it exits non-zero before any phase.  Long
tables (compiled HLO lines, the trace reduction) go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
import traceback

PHASES = ("env", "gpu_tests", "dgemm", "identity", "zgemm", "intercept", "hpl", "kernels")

#: problem sizes per phase
FULL = {
    "dgemm": 16384,
    "dgemm_oracle": 4096,
    "identity": (1023, 1234, 777),
    "zgemm": 8192,
    "zgemm_oracle": 2048,
    "intercept": 8192,
    "traced": 4096,
    "hpl": 8192,
    "hpl_block": 1024,
    "kernels": 16384,
    "four": 16384,
    "four_lu": 8192,
    "four_lu_block": 1024,
}


def say(*args):
    print(*args, flush=True)


def rel(x, ref):
    """Relative Frobenius residual, computed where the arrays live."""
    import jax.numpy as jnp

    return float(jnp.linalg.norm(x - ref) / jnp.linalg.norm(ref))


def warm_seconds(fn, *args, iters=3):
    """Median of ``iters`` warm calls, each timed to block_until_ready."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    say(f"  ok: {what}")


def peak_bytes(compiled) -> int:
    """Peak device memory of a compiled program: arguments, outputs and
    temporaries, less what the outputs alias."""
    ma = compiled.memory_analysis()
    return (ma.argument_size_in_bytes + ma.output_size_in_bytes
            + ma.temp_size_in_bytes - ma.alias_size_in_bytes)


def bits_equal(x, y) -> bool:
    import numpy as np

    x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
    return x.shape == y.shape and bool((x.view(np.uint64) == y.view(np.uint64)).all())


class Smoke:
    def __init__(self, out=None, gpu=None, cpu=None):
        import jax

        self.s = dict(FULL)
        self.out = out
        self.gpu = gpu or jax.devices()[0]
        self.cpu = cpu or jax.devices("cpu")[0]
        if out:
            os.makedirs(out, exist_ok=True)

    def write(self, name, text):
        if self.out:
            with open(os.path.join(self.out, name), "w") as f:
                f.write(text)

    # -- phases ---------------------------------------------------------------

    def env(self):
        import jax
        import jaxlib

        d = jax.devices()
        say(f"  jax {jax.__version__} jaxlib {jaxlib.__version__}")
        say(f"  devices: {len(d)} x {d[0].device_kind} ({d[0].platform})")
        stats = d[0].memory_stats() or {}
        say(f"  bytes_limit: {stats.get('bytes_limit')}")
        from ozimmu_tpu.schedule import hbm_budget_bytes

        say(f"  engine memory budget: {hbm_budget_bytes()} bytes")
        from ozimmu_tpu.bench_cli import gpu_power_limit

        line = gpu_power_limit()  # name, power.limit as nvidia-smi prints them
        check(line != "n/a", "nvidia-smi reads the card")
        say(line)

    def gpu_tests(self):
        import pytest

        here = os.path.dirname(os.path.abspath(__file__))
        counts = {"passed": 0, "failed": 0, "skipped": 0}

        class Count:
            def pytest_runtest_logreport(self, report):
                if report.when == "call" or report.outcome != "passed":
                    counts[report.outcome] = counts.get(report.outcome, 0) + 1

        os.environ["OZ_TEST_PLATFORM"] = "gpu"
        rc = pytest.main(
            ["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
             os.path.join(here, "tests", "test_gpu.py")],
            plugins=[Count()],
        )
        say(f"  gpu tests: {counts}")
        check(rc == 0 and counts["failed"] == 0 and counts["skipped"] == 0
              and counts["passed"] > 0, "every gpu-marked test passed, none skipped")

    def dgemm(self):
        import jax
        import jax.numpy as jnp

        import ozimmu_tpu as oz
        from ozimmu_tpu.core.f64x import from_f64, to_f64
        from ozimmu_tpu.schedule import auto_n_chunks
        from ozimmu_tpu.testing import error_metrics, generate_input

        n = self.s["dgemm"]
        say(f"  column panels at {n}^3 ns=9: {auto_n_chunks(n, n, n, 9)}")
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        a = jax.random.uniform(k1, (n, n), dtype=jnp.float64)
        b = jax.random.uniform(k2, (n, n), dtype=jnp.float64)
        ax, bx = from_f64(a), from_f64(b)
        t0 = time.perf_counter()
        c = oz.gemm(ax, bx, mode="fp64_int8_9")
        say(f"  first call (compile + run): {time.perf_counter() - t0:.3f} s")
        ref = jnp.dot(a, b, preferred_element_type=jnp.float64)
        r = rel(to_f64(c), ref)
        t = warm_seconds(lambda: oz.gemm(ax, bx, mode="fp64_int8_9"))
        tn = warm_seconds(lambda: jnp.dot(a, b, preferred_element_type=jnp.float64))
        say(f"  {n}^3 fp64_int8_9: {t:.4f} s ({2 * n**3 / t / 1e12:.3f} eff TFLOP/s); "
            f"cuBLAS DGEMM {tn:.4f} s ({2 * n**3 / tn / 1e12:.3f} TFLOP/s)")
        check(r < 1e-14, f"{n}^3 residual vs cuBLAS DGEMM {r:.3e} < 1e-14")
        del c

        # the deepest fixed mode and AUTO under the interceptor at the same
        # size: the planner's panel count must keep the program in memory
        import ozimmu_tpu.intercept as ozi
        from ozimmu_tpu.core.gemm import gemm_f64x

        limit = jax.devices()[0].memory_stats()["bytes_limit"]
        say(f"  column panels at {n}^3 ns=18: {auto_n_chunks(n, n, n, 18)}")
        deep = jax.jit(lambda x, y: gemm_f64x(x, y, 18)).lower(ax, bx).compile()
        check(peak_bytes(deep) <= limit,
              f"{n}^3 fp64_int8_18 compiled peak {peak_bytes(deep)} <= bytes_limit {limit}")
        t0 = time.perf_counter()
        r = rel(to_f64(jax.block_until_ready(deep(ax, bx))), ref)
        say(f"  {n}^3 fp64_int8_18 run: {time.perf_counter() - t0:.3f} s")
        check(r < 1e-14, f"{n}^3 fp64_int8_18 residual vs cuBLAS DGEMM {r:.3e} < 1e-14")
        del deep, ax, bx
        with ozi.intercept(mode="fp64_int8_auto"):
            auto = jax.jit(lambda x, y: x @ y).lower(a, b).compile()
        check(peak_bytes(auto) <= limit,
              f"{n}^3 AUTO under the interceptor: compiled peak {peak_bytes(auto)} "
              f"<= bytes_limit {limit}")
        r = rel(jax.block_until_ready(auto(a, b)), ref)
        check(r < 1e-14, f"{n}^3 AUTO under the interceptor: residual {r:.3e} < 1e-14")
        del a, b, ref, auto

        m = self.s["dgemm_oracle"]
        a = generate_input("urand01", (m, m), seed=1)
        b = generate_input("urand01", (m, m), seed=2)
        c = oz.gemm(a, b, mode="fp64_int8_9")
        err = error_metrics(c, a, b)
        check(err["relative_residual"] < 1e-15,
              f"{m}^3 residual vs long-double oracle {err['relative_residual']:.3e} < 1e-15")

    def identity(self):
        import jax

        import ozimmu_tpu as oz
        from ozimmu_tpu.testing import generate_input

        m, n, k = self.s["identity"]
        a = generate_input("exp_rand-3", (m, k), seed=3)
        b = generate_input("exp_rand-3", (k, n), seed=4)

        def on(dev, fn):
            with jax.default_device(dev):
                return fn()

        for mode in ("fp64_int8_9", "fp64_int8_18"):
            g = on(self.gpu, lambda: oz.gemm(a, b, mode=mode))
            c = on(self.cpu, lambda: oz.gemm(a, b, mode=mode))
            check(bits_equal(g, c), f"{mode} {m}x{n}x{k}: GPU bitwise equal to CPU")
        sel_g = on(self.gpu, lambda: oz.auto_mode_select(a, b))
        sel_c = on(self.cpu, lambda: oz.auto_mode_select(a, b))
        check(sel_g == sel_c, f"AUTO selects {sel_g.value} on both backends")
        g = on(self.gpu, lambda: oz.gemm(a, b, mode="fp64_int8_auto"))
        c = on(self.cpu, lambda: oz.gemm(a, b, mode="fp64_int8_auto"))
        if sel_g.is_int8:
            check(bits_equal(g, c), "AUTO result: GPU bitwise equal to CPU")
        else:
            import numpy as np

            r = float(np.linalg.norm(g - c) / np.linalg.norm(c))
            check(r < 1e-15, f"AUTO native fallback: GPU vs CPU residual {r:.3e}")

    def zgemm(self):
        import jax.numpy as jnp
        import numpy as np

        import ozimmu_tpu as oz
        from ozimmu_tpu.core import api
        from ozimmu_tpu.testing import error_metrics, generate_input

        n = self.s["zgemm"]
        a = generate_input("urand01", (n, n), seed=5, complex_=True)
        b = generate_input("urand01", (n, n), seed=6, complex_=True)
        t0 = time.perf_counter()
        c = oz.gemm(a, b, mode="fp64_int8_9")
        say(f"  {n}^3 complex fp64_int8_9, first call: {time.perf_counter() - t0:.3f} s")
        ref = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b)))
        r = float(np.linalg.norm(c - ref) / np.linalg.norm(ref))
        check(r < 1e-14, f"{n}^3 ZGEMM residual vs on-card complex128 product {r:.3e} < 1e-14")
        del a, b, c, ref

        m = self.s["zgemm_oracle"]
        a = generate_input("urand01", (m, m), seed=7, complex_=True)
        b = generate_input("urand01", (m, m), seed=8, complex_=True)
        err = error_metrics(oz.gemm(a, b, mode="fp64_int8_9"), a, b)
        check(err["relative_residual"] < 1e-15,
              f"{m}^3 ZGEMM residual vs long-double oracle {err['relative_residual']:.3e} < 1e-15")

        # complex mode="dgemm": the product must be computed on the device
        seen = []
        orig = api._native_gemm

        def spy(*args, **kw):
            out = orig(*args, **kw)
            seen.append({d.platform for d in out.devices()})
            return out

        api._native_gemm = spy
        try:
            cd = oz.gemm(a, b, mode="dgemm")
        finally:
            api._native_gemm = orig
        check(seen == [{self.gpu.platform}], f"complex dgemm ran on {seen}")
        r = float(np.linalg.norm(cd - a @ b) / np.linalg.norm(a @ b))
        check(r < 1e-14, f"complex dgemm residual vs host product {r:.3e} < 1e-14")

    def intercept(self):
        import jax
        import jax.numpy as jnp

        import ozimmu_tpu.intercept as ozi
        from ozimmu_tpu import traced

        n = self.s["intercept"]
        k1, k2 = jax.random.split(jax.random.PRNGKey(9))
        # entries far outside float32's range: exact only with bitcasts
        a = jax.random.uniform(k1, (n, n), dtype=jnp.float64) * 2.0**200
        b = jax.random.uniform(k2, (n, n), dtype=jnp.float64) * 2.0**-200
        ref = jnp.dot(a, b, preferred_element_type=jnp.float64)
        for mode in ("fp64_int8_9", "fp64_int8_auto"):
            before = ozi.routed_calls().get("2d", 0)
            t0 = time.perf_counter()
            with ozi.intercept(mode=mode):
                c = jax.block_until_ready(jax.jit(lambda x, y: x @ y)(a, b))
            say(f"  intercept {mode} {n}^3 first call: {time.perf_counter() - t0:.3f} s")
            check(ozi.routed_calls().get("2d", 0) == before + 1,
                  f"{mode}: the jitted a @ b was routed to the engine")
            r = rel(c, ref)
            check(r < 1e-14, f"{mode}: residual vs cuBLAS DGEMM {r:.3e} < 1e-14")
        del a, b, c, ref

        m = self.s["traced"]
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(10), 3)
        a = jax.random.uniform(k1, (m, m), dtype=jnp.float64)
        b = jax.random.uniform(k2, (m, m), dtype=jnp.float64)
        c = jax.random.uniform(k3, (m, m), dtype=jnp.float64)
        step = jax.jit(lambda x, y, z: traced.gemm(x, y, alpha=0.75, beta=-1.25, c=z))
        got = step(a, b, c)
        ref = 0.75 * jnp.dot(a, b, preferred_element_type=jnp.float64) - 1.25 * c
        r = rel(got, ref)
        check(r < 1e-14, f"traced.gemm {m}^3 alpha/beta/c under jit: residual {r:.3e} < 1e-14")

    def hpl(self):
        import jax
        import jax.numpy as jnp
        import jax.scipy.linalg as jsl
        import numpy as np

        from ozimmu_tpu import linalg
        from ozimmu_tpu.core.f64x import from_f64

        n, nb = self.s["hpl"], self.s["hpl_block"]
        k1, k2 = jax.random.split(jax.random.PRNGKey(11))
        a = jax.random.uniform(k1, (n, n), dtype=jnp.float64) - 0.5
        x_true = np.asarray(jax.random.normal(k2, (n,), dtype=jnp.float64))
        b = np.asarray(jnp.dot(a, jnp.asarray(x_true)))
        eps = np.finfo(np.float64).eps

        def hpl_resid(x):
            r = np.asarray(jnp.dot(a, jnp.asarray(x))) - b
            an = float(jnp.max(jnp.sum(jnp.abs(a), axis=1)))
            return float(np.max(np.abs(r)) / (eps * (an * np.max(np.abs(x)) + np.max(np.abs(b))) * n))

        ax = from_f64(a)
        t0 = time.perf_counter()
        x = linalg.solve(ax, b, mode="fp64_int8_9", block=nb, panel="device")
        t_eng = time.perf_counter() - t0
        t0 = time.perf_counter()
        lu = jsl.lu_factor(a)
        xs = np.asarray(jsl.lu_solve(lu, jnp.asarray(b)))
        t_sol = time.perf_counter() - t0
        r_eng, r_sol = hpl_resid(x), hpl_resid(xs)
        say(f"  n={n} block={nb}: engine LU solve {t_eng:.3f} s (first call, compile "
            f"included), scaled residual {r_eng:.4f}; cuSOLVER lu_factor/lu_solve "
            f"{t_sol:.3f} s, scaled residual {r_sol:.4f}")
        check(r_eng < 16, f"HPL scaled residual {r_eng:.4f} < 16")

    def kernels(self):
        import jax
        import jax.numpy as jnp

        from ozimmu_tpu.core.f64x import from_f64
        from ozimmu_tpu.core.gemm import _epilogue_SE, _gemm_core
        from ozimmu_tpu.ops.recombine import acc_shift, fold_group_totals
        from ozimmu_tpu.ops.split import split_f64x
        from ozimmu_tpu.schedule import bits_per_int8, group_schedule

        n, ns = self.s["kernels"], 9
        bb = bits_per_int8(n)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(12), 3)
        ax = from_f64(jax.random.uniform(k1, (n, n), dtype=jnp.float64))
        bx = from_f64(jax.random.uniform(k2, (n, n), dtype=jnp.float64))

        # the very program oz.gemm runs at this shape
        eng = _gemm_core.lower(ax, bx, ns, 1.0, 0.0).compile()
        hlo = eng.as_text()
        self.write("engine_hlo.txt", hlo)
        kinds = {}
        for m_ in re.finditer(r'"fusion_backend_config":\{"kind":"(__triton[a-z_]*gemm[a-z_]*)"', hlo):
            kinds[m_.group(1)] = kinds.get(m_.group(1), 0) + 1
        for m_ in re.finditer(r'custom_call_target="(__cublas[^"]*)"', hlo):
            kinds[m_.group(1)] = kinds.get(m_.group(1), 0) + 1
        say(f"  s8 GEMM lowering in the compiled engine: {kinds}; "
            f"while loops: {len(re.findall(r' while\(', hlo))}")
        say(f"  memory_analysis: {eng.memory_analysis()}")

        copy = jax.jit(lambda x: x + jnp.uint32(1))
        t_copy = warm_seconds(copy, ax.hi)
        copy_rate = 2 * 4 * n * n / t_copy
        split_rows = jax.jit(lambda x: split_f64x(x, ns, bb))
        t_split = warm_seconds(split_rows, ax)
        split_bytes = (8 + ns) * n * n  # read hi+lo, write ns int8 planes
        say(f"  copy u32[{n},{n}]: {t_copy * 1e3:.3f} ms, {copy_rate / 1e9:.1f} GB/s")
        say(f"  split A ({ns} planes): {t_split * 1e3:.3f} ms, "
            f"{split_bytes / t_split / 1e9:.1f} GB/s = {split_bytes / t_split / copy_rate:.2f} of the copy")

        groups = group_schedule(ns, n, bb)
        # every pair GEMM of the engine has this one shape
        xa = jnp.ones((n, n), jnp.int8)
        plain = jax.jit(lambda x, y: jax.lax.dot_general(
            x, y, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
        t_plain = warm_seconds(plain, xa, xa)
        plain_rate = 2.0 * n**3 / t_plain / 1e12
        del xa
        say(f"  plain s8 matmul {n}x{n}x{n}: {t_plain * 1e3:.3f} ms ({plain_rate:.1f} TOP/s)")

        totals = [jax.random.randint(k3, (n, n), -(2**30), 2**30, jnp.int32)] * len(groups)
        pa = pb = jnp.full((n,), 3, jnp.int32)

        def fold_pack(ts, pa, pb):
            S = fold_group_totals(ts, ns, n, bb)
            E = (pa[:, None] + pb[None, :] - acc_shift(ns, bb)).astype(jnp.int32)
            return _epilogue_SE(S, E, 1.0, 0.0, None)

        t_fold = warm_seconds(jax.jit(fold_pack), totals, pa, pb)
        say(f"  fold + pack ({len(groups)} int32 totals): {t_fold * 1e3:.3f} ms")
        S = jax.jit(fold_group_totals, static_argnums=(1, 2, 3))(totals, ns, n, bb)
        E = jnp.full((n, n), 3, jnp.int32)
        del totals
        epi = jax.jit(_epilogue_SE, static_argnums=(2, 3))
        t_pack = warm_seconds(lambda: epi(S, E, 1.0, 0.0, None))
        cx = from_f64(jax.random.uniform(k3, (n, n), dtype=jnp.float64))
        t_axby = warm_seconds(lambda: epi(S, E, 0.75, -1.25, cx))
        say(f"  epilogue: pack alone {t_pack * 1e3:.3f} ms; alpha=0.75, beta=-1.25 "
            f"with c {t_axby * 1e3:.3f} ms")
        del S, E, cx
        t_eng = warm_seconds(eng, ax, bx)
        say(f"  whole engine {n}^3 ns={ns}: {t_eng * 1e3:.3f} ms "
            f"({2 * n**3 / t_eng / 1e12:.3f} eff TFLOP/s)")

        trace_dir = os.path.join(self.out or ".", "trace")
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(eng(ax, bx))
        events, summary = reduce_trace(trace_dir, self)
        say("  trace: " + summary)
        # every pair GEMM of the engine is one n x n x n int8 matmul
        gemms = [ms for name, ms in events if "gemm" in name.lower()]
        if gemms:
            in_engine = sum(gemms)
            rate = len(gemms) * 2.0 * n**3 / in_engine / 1e9
            say(f"  in-engine pair GEMMs: {len(gemms)} of {min(gemms):.3f}-{max(gemms):.3f} ms, "
                f"{in_engine:.3f} ms at {rate:.1f} TOP/s = {rate / plain_rate:.3f} of the "
                f"plain s8 matmul's rate")

    def four_gpus(self):
        import jax
        import numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        import ozimmu_tpu as oz
        from ozimmu_tpu import linalg
        from ozimmu_tpu.core.f64x import F64X, from_f64
        from ozimmu_tpu.core.gemm import gemm_f64x, zgemm_f64x
        from ozimmu_tpu.parallel.gemm import (
            make_mesh_2d, sharded_gemm_auto, sharded_gemm_fn, sharded_gemm_k_fn,
            sharded_gemm_ring_fn, sharded_zgemm_fn,
        )
        from ozimmu_tpu.testing import generate_input

        devs = jax.devices()
        check(len(devs) >= 4, f"{len(devs)} GPUs visible")
        n, ns = self.s["four"], 9
        d0 = devs[0]
        mesh = make_mesh_2d(4)
        kmesh = Mesh(np.array(devs[:4]), ("k",))
        say(f"  2D mesh {mesh.devices.shape}, 1-D mesh (4,)")

        def gen(seed, shape):
            return np.asarray(jax.device_get(
                jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype="float64")))

        def put(x, mesh_, spec):
            fx = from_f64(jax.device_put(x, NamedSharding(mesh_, spec)))
            return fx

        def single(x, y):
            with jax.default_device(d0):
                return gemm_f64x(F64X.from_numpy(x), F64X.from_numpy(y), ns).to_numpy()

        t0 = time.perf_counter()

        def lap(what):
            nonlocal t0
            say(f"  {what}: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()

        a, b = gen(20, (n, n)), gen(21, (n, n))
        want = single(a, b)
        lap("inputs and the one-GPU reference")
        pxy = P("x", "y")
        for name, fn in (("summa", sharded_gemm_fn(mesh, ns, n)),
                         ("ring", sharded_gemm_ring_fn(mesh, ns, n))):
            got = jax.jit(fn)(put(a, mesh, pxy), put(b, mesh, pxy)).to_numpy()
            check(bits_equal(got, want), f"{name} {n}^3 on 2x2: bitwise equal to one GPU")
            lap(name)
        got = jax.jit(sharded_gemm_k_fn(kmesh, ns, n))(
            put(a, kmesh, P(None, "k")), put(b, kmesh, P("k", None))).to_numpy()
        check(bits_equal(got, want), f"k variant {n}^3 on 1-D mesh: bitwise equal to one GPU")
        lap("k variant")
        del got, want

        want = oz.gemm(a, b, mode="fp64_int8_auto")
        got = sharded_gemm_auto(a, b, "auto", mesh)
        check(bits_equal(got, want), f"sharded_gemm_auto {n}^3: bitwise equal to one GPU")
        lap("sharded_gemm_auto and its one-GPU reference")
        del got, want

        ar, ai = a, gen(22, (n, n))
        br, bi = b, gen(23, (n, n))
        with jax.default_device(d0):
            wr, wi = zgemm_f64x(*(F64X.from_numpy(x) for x in (ar, ai, br, bi)), ns)
            wr, wi = wr.to_numpy(), wi.to_numpy()
        gr, gi = jax.jit(sharded_zgemm_fn(mesh, ns, n))(
            *(put(x, mesh, pxy) for x in (ar, ai, br, bi)))
        check(bits_equal(gr.to_numpy(), wr) and bits_equal(gi.to_numpy(), wi),
              f"sharded_zgemm {n}^3 on 2x2: bitwise equal to one GPU")
        lap("sharded_zgemm and its one-GPU reference")
        del a, b, ar, ai, br, bi, gr, gi, wr, wi

        m, nb = self.s["four_lu"], self.s["four_lu_block"]
        alu = gen(24, (m, m)) + m * np.eye(m)
        rows = Mesh(np.array(devs[:4]), ("x",))
        lu_m, piv_m = linalg.lu_factor(alu, mode="fp64_int8_9", block=nb, mesh=rows)
        lap(f"row-sharded lu_factor n={m}")
        with jax.default_device(d0):
            lu_1, piv_1 = linalg.lu_factor(alu, mode="fp64_int8_9", block=nb, device=True)
        lap(f"one-GPU lu_factor n={m}")
        check(bool((piv_m == piv_1).all()) and bits_equal(lu_m, lu_1),
              f"row-sharded lu_factor n={m} on 4 GPUs: bitwise equal to one GPU")


def reduce_trace(trace_dir, smoke):
    """Device kernels of a profiler trace: the time-ordered (name, ms)
    list of the compute stream, and a summary line with the GEMM
    kernels' share and the largest other kernels."""
    import glob

    import jax

    files = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb"))
    if not files:
        return [], "no trace file"
    pd = jax.profiler.ProfileData.from_file(max(files, key=os.path.getmtime))
    best = []
    lines = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = sorted(line.events, key=lambda e: e.start_ns)
            evs = [(e.name, e.duration_ns / 1e6) for e in evs]
            lines.append(f"== {plane.name} | {line.name}: "
                         f"{sum(ms for _, ms in evs):.3f} ms in {len(evs)} events")
            lines += [f"{ms:12.3f} ms  {name}" for name, ms in evs]
            if line.name.startswith("Stream") and len(evs) > len(best):
                best = evs
    smoke.write("trace_reduction.txt", "\n".join(lines) + "\n")
    total = sum(ms for _, ms in best)
    if not total:
        return best, "no GPU compute stream"
    gemm = sum(ms for k, ms in best if "gemm" in k.lower())
    other = {}
    for k, ms in best:
        if "gemm" not in k.lower():
            other[k] = other.get(k, 0.0) + ms
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    return best, (f"{total:.3f} ms of kernels in {len(best)} launches: int8 GEMMs "
                  f"{gemm / total:.3f}; largest others "
                  + ", ".join(f"{k} {ms:.3f} ms" for k, ms in top))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the distributed engine on four GPUs")
    p.add_argument("--phase", action="append", choices=PHASES,
                   help="run only these phases (repeatable)")
    p.add_argument("--out", default="smoke_out",
                   help="directory for long outputs (compiled HLO, trace)")
    args = p.parse_args(argv)

    t_start = time.perf_counter()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    from ozimmu_tpu.utils.cache import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    smoke = Smoke(out=args.out)
    if args.four_gpus:
        from ozimmu_tpu.bench_cli import gpu_power_limit

        say(gpu_power_limit())
        phases = ["four_gpus"]
    else:
        phases = args.phase or list(PHASES)
        if "env" not in phases:
            phases = ["env"] + phases
    failed = []
    for name in phases:
        say(f"[{name}]")
        t0 = time.perf_counter()
        try:
            getattr(smoke, name)()
        except Exception:  # report, run the rest, exit non-zero at the end
            traceback.print_exc()
            failed.append(name)
            say(f"[{name}] FAILED")
        say(f"[{name}] {time.perf_counter() - t0:.1f} s")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    if failed:
        say(f"failed phases: {failed}")
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
