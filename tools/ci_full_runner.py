"""Full reference ci_test matrix runner (resumable, oracle-sharing).

The reference gate (test/main_test.cu:702-746): m,n,k in {1023,1024,1025}
x opA/B in {N,T} x modes int8_8..16 x {real, complex}, urand01, residual
< 1e-15 — 1944 GEMMs.  The pytest parametrization recomputes the
long-double oracle per case (9x per operand set); on a few-core host that
dominates wall time, so this runner sweeps all nine modes per (sizes, ops)
operand set and scores them against ONE oracle accumulation
(native.error_metrics_multi_native).

Resumable: completed case-set lines are skipped on restart.

Usage: python tools/ci_full_runner.py {real|complex} [logfile]
"""

import itertools
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from ozimmu_tpu.utils.cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
enable_compile_cache(min_compile_secs=0.5)

import numpy as np  # noqa: E402

import ozimmu_tpu as oz  # noqa: E402
from ozimmu_tpu import native  # noqa: E402
from ozimmu_tpu.testing import generate_input  # noqa: E402

SIZES = (1023, 1024, 1025)
MODES = tuple(f"fp64_int8_{ns}" for ns in range(8, 17))
THRESHOLD = 1e-15


def main(kind: str, logfile: str) -> int:
    complex_ = kind == "complex"
    done = set()
    if os.path.exists(logfile):
        with open(logfile) as f:
            for line in f:
                if line.startswith("SET "):
                    done.add(line.split()[1])
    failures = 0
    cases = 0
    ran_sets = 0
    with open(logfile, "a", buffering=1) as log:
        for (m, n, k), (op_a, op_b) in itertools.product(
            itertools.product(SIZES, repeat=3), itertools.product("NT", "NT")
        ):
            key = f"{kind}-{m}x{n}x{k}-{op_a}{op_b}"
            if key in done:
                cases += len(MODES)
                continue
            # the in-memory executable cache grows by 9 engine programs
            # per operand set; unbounded it exhausts host
            # RAM after ~100 sets (LLVM "Cannot allocate memory").  The
            # persistent disk cache makes re-tracing cheap.
            ran_sets += 1
            if ran_sets % 20 == 0:
                jax.clear_caches()
            # deterministic seeds (zlib.crc32, not the per-process-salted
            # built-in hash()) so a resumed or re-run sweep reproduces the
            # exact operands of every logged SET/FAIL line
            a = generate_input(
                "urand01",
                (m, k) if op_a == "N" else (k, m),
                seed=zlib.crc32(f"{m}-{k}-{op_a}".encode()) % 2**31,
                complex_=complex_,
            )
            b = generate_input(
                "urand01",
                (k, n) if op_b == "N" else (n, k),
                seed=zlib.crc32(f"{k}-{n}-{op_b}".encode()) % 2**31,
                complex_=complex_,
            )
            cs = [
                oz.gemm(a, b, mode=mode, op_a=op_a, op_b=op_b) for mode in MODES
            ]
            ae = np.ascontiguousarray(a if op_a == "N" else a.T)
            be = np.ascontiguousarray(b if op_b == "N" else b.T)
            errs = native.error_metrics_multi_native(cs, ae, be)
            assert errs is not None, "native oracle unavailable"
            line_fail = 0
            for mode, err in zip(MODES, errs):
                cases += 1
                ok = err["relative_residual"] < THRESHOLD
                if not ok:
                    failures += 1
                    line_fail += 1
                    log.write(
                        f"FAIL {key} {mode} residual={err['relative_residual']:.3e} "
                        f"max_rel={err['max_relative_error']:.3e}\n"
                    )
            set_max = max(e["relative_residual"] for e in errs)
            log.write(
                f"SET {key} modes={len(MODES)} failures={line_fail} "
                f"max_residual={set_max:.3e}\n"
            )
        log.write(f"DONE kind={kind} cases={cases} failures={failures}\n")
    print(f"{cases - failures}/{cases} PASSED")
    return 1 if failures else 0


if __name__ == "__main__":
    kind = sys.argv[1] if len(sys.argv) > 1 else "complex"
    logfile = (
        sys.argv[2] if len(sys.argv) > 2 else f"ci_full_{kind}_runner.log"
    )
    sys.exit(main(kind, logfile))
