"""Device bring-up guards: the compile-cache location, the chip-only entry
points refusing to run without a GPU, no Pallas on the device path, and the
profiler trace helper reading only its own run's file.

Each check runs in a fresh interpreter: the cache directory is process-wide
JAX configuration, and sys.modules must not see other tests' imports."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_extra=None, drop=(), args=None, timeout=600):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.update(env_extra or {})
    cmd = [sys.executable] + (args if args is not None else ["-c", code])
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


_CACHE_PROBE = """
import jax, jax.numpy as jnp
from poreseq_tpu.jaxcache import enable_compilation_cache
enable_compilation_cache()
hits = []
jax.monitoring.register_event_listener(lambda name, **kw: hits.append(name))
COMPILE = {compile}
if COMPILE:
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.ones(16)).block_until_ready()
print(jax.config.jax_compilation_cache_dir,
      hits.count("/jax/compilation_cache/cache_hits"))
"""


def test_cache_honours_jax_compilation_cache_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no other
    directory, and a second cold process hits what the first compiled."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    outs = []
    for _ in range(2):
        r = _python(_CACHE_PROBE.format(compile=True), env)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout.split())
    assert outs[0] == [str(tmp_path), "0"]
    assert outs[1][0] == str(tmp_path) and int(outs[1][1]) >= 1
    assert os.listdir(tmp_path)


def test_cache_defaults_to_fixed_checkout_path():
    from poreseq_tpu.jaxcache import CACHE_DIR

    r = _python(_CACHE_PROBE.format(compile=False),
                drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[0] == CACHE_DIR
    assert os.path.dirname(CACHE_DIR) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu():
    r = _python(None, args=[os.path.join(REPO, "chip_smoke.py")])
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
    assert "not a GPU" in r.stdout


def test_bench_refuses_cpu():
    r = _python(None, args=[os.path.join(REPO, "bench.py")])
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]


_NO_PALLAS = """
import sys
import numpy as np
from poreseq_tpu.engine.driver import find_point_mutations
from poreseq_tpu.engine.tpu import TpuEngine
from poreseq_tpu.engine.types import AlignData
from poreseq_tpu.sim import simulate_session

pa, _ = simulate_session(np.random.default_rng(4), ref_len=60, coverage=3,
                         draft_error=0.03, backend="tpu",
                         params=dict(realign_width=12, scoring_width=6))
d = AlignData.from_session(pa)
muts = find_point_mutations(d)[:20]
scores = [m.score for m in TpuEngine().score_mutations(d, muts)]
print(json.dumps([len(scores), bool(np.all(np.isfinite(scores))),
                  any(m.startswith("jax.experimental.pallas")
                      for m in sys.modules)]))
"""


def test_f32_score_mutations_imports_no_pallas():
    r = _python("import json\n" + _NO_PALLAS)
    assert r.returncode == 0, r.stderr[-2000:]
    n, finite, pallas = json.loads(r.stdout.strip().splitlines()[-1])
    assert n == 20 and finite
    assert not pallas


_TRACE_PROBE = """
import json, os, jax, jax.numpy as jnp
from poreseq_tpu.profiling import summarize, trace
d = {d!r}
paths = []
for k in range(3):
    with trace(d if k < 2 else None) as tr:
        jax.jit(lambda x: x * k)(jnp.ones(8)).block_until_ready()
    paths.append(tr.path)
try:
    summarize(paths[1])
    err = None
except RuntimeError as e:
    err = str(e)
print(json.dumps([paths, err]))
"""


def test_trace_reads_only_its_own_file(tmp_path):
    """Each trace names the file it wrote, also in a directory that holds an
    earlier trace; without a directory it writes into a new one under
    TMPDIR.  A CPU trace holds no device kernel, which summarize says."""
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    r = _python(_TRACE_PROBE.format(d=str(tmp_path / "tr")),
                {"TMPDIR": str(scratch)})
    assert r.returncode == 0, r.stderr[-2000:]
    paths, err = json.loads(r.stdout.strip().splitlines()[-1])
    for p in paths:
        assert p and p.endswith(".xplane.pb") and os.path.isfile(p)
    assert paths[0].startswith(str(tmp_path / "tr"))
    assert paths[1].startswith(str(tmp_path / "tr"))
    assert os.path.getmtime(paths[1]) >= os.path.getmtime(paths[0])
    assert paths[2].startswith(str(scratch))
    assert err and "no device kernel" in err


def test_cli_profile_uses_the_trace_helper(monkeypatch, tmp_path):
    """`consensus --profile DIR` runs the whole consensus inside
    poreseq_tpu.profiling.trace(DIR), whose options raise the GPU tracer's
    event buffers past a consensus run's count."""
    import argparse
    import contextlib

    from poreseq_tpu import cli, profiling

    calls = []

    @contextlib.contextmanager
    def fake_trace(log_dir):
        calls.append(("start", log_dir))
        yield argparse.Namespace(path=os.path.join(log_dir, "t.xplane.pb"))
        calls.append(("stop", log_dir))

    monkeypatch.setattr(profiling, "trace", fake_trace)
    monkeypatch.setattr(cli, "_consensus",
                        lambda args: calls.append(("run", args.profile)))
    cli.consensus(argparse.Namespace(profile=str(tmp_path)))
    assert calls == [("start", str(tmp_path)), ("run", str(tmp_path)),
                     ("stop", str(tmp_path))]
    opts = profiling.profiler_options().advanced_configuration
    assert opts["gpu_max_activity_api_events"] >= 1 << 22


def test_summarize_program_split_does_not_alias():
    """A scan body launches the same kernels in a fixed order; the sampled
    program split must not lock onto that period.  Here program `a` runs one
    long kernel then seven short ones of program `b` (period 8, a divisor of
    the sampling rate), and a long kernel takes 8/15 of the kernel time."""
    from types import SimpleNamespace as NS

    from poreseq_tpu.profiling import summarize

    events, t = [], 0
    for _ in range(4000):
        for k in range(8):
            mod, dur = ("jit_a", 8) if k == 0 else ("jit_b", 1)
            events.append(NS(name="k{}".format(k), start_ns=t, duration_ns=dur,
                             stats=[("hlo_module", mod)]))
            t += dur + 1
    pd = NS(planes=[NS(name="/device:GPU:0",
                       lines=[NS(name="Stream #1", events=events)])])
    out = []
    idle = summarize(pd, write=out.append)
    share = {ln.split()[1]: float(ln.split()[0].rstrip("%"))
             for ln in out if ln.strip().endswith(("jit_a", "jit_b"))
             and len(ln.split()) == 2}
    assert abs(share["jit_a"] - 100 * 8 / 15) < 3, out
    gaps = 8 * 4000 - 1                  # 1 ns between kernels
    assert abs(idle - gaps / (15 * 4000 + gaps)) < 1e-9
