"""Start-up and tooling contracts: where the compile cache lives, the
benchmark's peaks table, and the GPU-only entry points refusing the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(code_or_args, env_extra=None, drop=(), cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable, *code_or_args])
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing else
    is configured; unset, `import gf3x` puts it at <repo>/.jax_cache."""
    code = ("import gf3x, jax; print(gf3x.compile_cache_dir()); "
            "print(jax.config.jax_compilation_cache_dir)")
    if env_set:
        out = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        want = str(tmp_path)
    else:
        out = _run(code, drop=("JAX_COMPILATION_CACHE_DIR",))
        want = str(ROOT / ".jax_cache")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [want, want]


def test_bench_peaks_lookup():
    sys.path.insert(0, str(ROOT))
    import bench

    p = bench.peaks("NVIDIA H100 80GB HBM3")
    assert p == {"hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989e12}
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks("cpu")


def test_chip_smoke_refuses_the_cpu(tmp_path):
    """No GPU: a non-zero exit that says so, and no result line — from the
    repo, and from a directory holding the script and nothing else."""
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd == tmp_path:
            (tmp_path / script).write_text((ROOT / script).read_text())
        out = _run([script], cwd=cwd)
        assert out.returncode != 0
        assert "no GPU found" in out.stderr
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("argv", [["--device", "gpu", "info"], ["sweep"]])
def test_cli_gpu_commands_fail_without_gpu(argv):
    """`--device gpu`, and sweep/bench by default, fail loudly with no GPU."""
    from gf3x.cli import main

    with pytest.raises(SystemExit, match="no GPU found"):
        main(argv)
