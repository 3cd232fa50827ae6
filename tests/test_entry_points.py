"""Entry-point contracts checked in fresh processes: the compile-cache
location, and chip_smoke.py refusing to report a CPU run."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=(), drop=(), cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(dict(env_extra))
    env["JAX_PLATFORMS"] = "cpu"
    args = code_or_args if isinstance(code_or_args, list) else \
        ["-c", code_or_args]
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


_PRINT_CACHE = (
    "import multigridbarrier_tpu, jax; "
    "print('CACHE=' + str(jax.config.jax_compilation_cache_dir))"
)


def _cache_dir(res):
    assert res.returncode == 0, res.stderr[-2000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("CACHE=")]
    return line[-1][len("CACHE="):]


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "jaxcache")
    res = _run(_PRINT_CACHE, env_extra={"JAX_COMPILATION_CACHE_DIR": want})
    assert _cache_dir(res) == want


def test_compile_cache_defaults_to_checkout():
    res = _run(_PRINT_CACHE, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert _cache_dir(res) == os.path.join(ROOT, ".jax_cache")


def test_chip_smoke_refuses_cpu():
    res = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_outside_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    res = _run([str(script)], drop=("PYTHONPATH",), cwd=str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
