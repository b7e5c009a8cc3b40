"""Entry points on a machine without a GPU: the compile-cache helper, the
device checks, chip_smoke.py's options and output contract, run_case.py's
platform flag and bench.py's refusal to time the CPU.

The GPU-only phases of chip_smoke.py also run here at small sizes on the
CPU (their arithmetic and checks); ``test_chip_smoke_on_gpu`` runs the
script itself and skips where there is no card.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from thermalporous_tpu import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _run(args, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=CPU_ENV,
                          capture_output=True, text=True, timeout=timeout)


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


# ------------------------------------------------------------ compile cache

@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    # nothing is set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch,
                                                      restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ------------------------------------------------------------ device checks

def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_device_summary_reports_jax_devices():
    s = runtime.device_summary()
    assert s == {"platform": jax.devices()[0].platform,
                 "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


def test_peak_memory_bandwidth_by_device_kind():
    class H100:
        device_kind = "NVIDIA H100 80GB HBM3"

    assert runtime.peak_memory_bandwidth(H100()) == 3.35e12


def test_peak_memory_bandwidth_unknown_kind_is_an_error():
    with pytest.raises(KeyError, match="no published memory bandwidth"):
        runtime.peak_memory_bandwidth(jax.devices()[0])


# ------------------------------------------------------------ chip_smoke.py

def test_chip_smoke_refuses_without_gpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert _json_lines(r.stdout) == []


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert _json_lines(r.stdout) == []


def test_chip_smoke_main_raises_before_printing(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert capsys.readouterr().out == ""


def test_chip_smoke_result_line_schema():
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1}}
    assert "\n" not in line


def test_chip_smoke_default_runs_single_card_phases():
    args = chip_smoke.parse_args([])
    assert args.devices == 1
    assert chip_smoke.PHASES[args.devices] == ("oracle", "flagship", "qualify")


def test_chip_smoke_devices_4_selects_only_the_sharded_phase():
    args = chip_smoke.parse_args(["--devices", "4"])
    assert chip_smoke.PHASES[args.devices] == ("sharded",)


def test_chip_smoke_rejects_other_device_counts():
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--devices", "2"])


def test_phase_oracle_small_on_cpu():
    out = chip_smoke.phase_oracle(n=6)
    assert all(e <= t for e, t in zip(out["max_abs_error"], out["atol"]))
    assert out["newton"] >= 1 and out["fgmres"] >= 1


def test_phase_flagship_checks_on_a_small_preset():
    out = chip_smoke.phase_flagship("tp_thermal_2d", steps=2)
    assert out["steps"] == 2 and out["newton"] >= 2
    check = out["balance_check"]
    assert check["steps"] == 2 and check["state"] == "f64"
    assert max(check["rel_error"].values()) <= chip_smoke.BALANCE_RTOL
    assert set(out["balance_rel_error"]) == set(check["rel_error"])
    assert out["first_call_s"] > 0 and out["run_s"] > 0


def test_phase_sharded_on_virtual_cpu_devices():
    out = chip_smoke.phase_sharded(4, shape=(8, 8, 6))
    assert out["mesh"] == (2, 2) and out["shape"] == (8, 8, 6)
    assert out["steps"] >= 1


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"


# ------------------------------------------------------------ run_case.py

sys.path.insert(0, os.path.join(ROOT, "examples"))
import run_case  # noqa: E402


def test_run_case_platform_mapping():
    assert run_case.PLATFORMS == {"cpu": "cpu", "gpu": "cuda"}


def test_run_case_gpu_refuses_without_gpu():
    r = _run(["examples/run_case.py", "--case", "tp_thermal_2d",
              "--platform", "gpu", "--max-steps", "1"])
    assert r.returncode != 0
    assert "# done" not in r.stdout


@pytest.mark.parametrize("flag", [["--fuse"], ["--pallas-gmg"],
                                  ["--fuse-below", "1000"],
                                  ["--platform", "rocm"]])
def test_run_case_rejects_removed_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        run_case.main(["--case", "tp_thermal_2d", *flag])
    assert e.value.code == 2


# ------------------------------------------------------------ bench.py

def test_bench_refuses_without_gpu():
    r = _run(["bench.py"])
    assert r.returncode != 0
    assert _json_lines(r.stdout) == []


# ------------------------------------------------------------ qualify

def test_qualify_case_fails_on_the_cpu():
    from thermalporous_tpu.qualify import qualify_case

    with pytest.raises(RuntimeError, match="default backend is the CPU"):
        qualify_case("tp_thermal_2d", steps=1, verbose=False)


def test_qualify_cpu_reference_is_pinned_and_matches_x64():
    from thermalporous_tpu.qualify import cpu_reference_cmd

    cmd = cpu_reference_cmd("tp_spe10_3d", steps=4, x64=True)
    assert cmd[cmd.index("--platform") + 1] == "cpu"
    assert "--x64" in cmd
    assert "--x64" not in cpu_reference_cmd("tp_spe10_3d", steps=4)


def test_qualify_cli_platform_choices():
    from thermalporous_tpu.qualify import _main

    with pytest.raises(SystemExit) as e:
        _main(["--case", "tp_thermal_2d", "--platform", "rocm"])
    assert e.value.code == 2
