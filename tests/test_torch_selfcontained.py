"""``repro_torch``, ``chip_smoke.py``, ``tools/kernel_ab.py`` and the
port's examples stand alone: no import of ``jax`` or of the reference
package ``repro``, by an AST scan of every module and by importing the
serving and the training modules, the launchers, the bus server, the
process harness and the core package (the agent kernel, the supervisor and
the network log among it) in a fresh interpreter; and the port's bus
server runs as a process of its own for a port ``NetBus``, and its
component CLI (``python -m repro_torch.launch.procs``) answers ``--help``
as a process of its own."""
import ast
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PACKAGE_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
PORT_FILES = PACKAGE_FILES + [
    ROOT / "tools" / "kernel_ab.py", ROOT / "chip_smoke.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "fault_tolerant_train_torch.py",
    ROOT / "examples" / "swarm_serve_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_modules_exist():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PACKAGE_FILES}
    assert {"repro_torch/serving/server.py", "repro_torch/core/agent.py",
            "repro_torch/kernels/paged_attention.py",
            "repro_torch/kernels/ssd_scan.py", "repro_torch/models/ssm.py",
            "repro_torch/configs/mamba2_780m.py",
            "repro_torch/kernels/flash_attention.py",
            "repro_torch/data/pipeline.py", "repro_torch/optim/optimizer.py",
            "repro_torch/optim/compression.py",
            "repro_torch/train/train_step.py",
            "repro_torch/train/checkpoint.py",
            "repro_torch/train/trainer.py", "repro_torch/core/introspect.py",
            "repro_torch/core/recovery.py", "repro_torch/core/kernel.py",
            "repro_torch/core/supervisor.py", "repro_torch/models/moe.py",
            "repro_torch/configs/gemma2_9b.py",
            "repro_torch/configs/chatglm3_6b.py",
            "repro_torch/configs/codeqwen15_7b.py",
            "repro_torch/configs/mixtral_8x7b.py",
            "repro_torch/configs/kimi_k2_1t_a32b.py",
            "repro_torch/launch/serve.py",
            "repro_torch/launch/train.py",
            "repro_torch/launch/dryrun.py",
            "repro_torch/distributed/analytic.py",
            "repro_torch/distributed/roofline.py",
            "repro_torch/core/netbus.py",
            "repro_torch/launch/bus_server.py",
            "repro_torch/launch/procs.py"} <= names
    assert {p.name for p in (ROOT / "src" / "repro_torch" / "csrc").glob(
        "*.cu")} >= {"paged_attention.cu", "ssd_scan.cu",
                     "flash_attention.cu"}
    assert all(p.exists() for p in PORT_FILES[len(PACKAGE_FILES):])


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_import_of_jax_or_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def _import_pulls_in_neither(module):
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_serving_import_pulls_in_neither():
    _import_pulls_in_neither("repro_torch.serving.server")


def test_training_import_pulls_in_neither():
    _import_pulls_in_neither("repro_torch.train.trainer")


def test_launch_import_pulls_in_neither():
    _import_pulls_in_neither("repro_torch.launch.serve")
    _import_pulls_in_neither("repro_torch.launch.train")
    _import_pulls_in_neither("repro_torch.launch.dryrun")


def test_core_import_pulls_in_neither():
    _import_pulls_in_neither("repro_torch.core")
    _import_pulls_in_neither("repro_torch.core.kernel")
    _import_pulls_in_neither("repro_torch.core.supervisor")
    _import_pulls_in_neither("repro_torch.core.netbus")


def test_bus_server_import_pulls_in_neither():
    _import_pulls_in_neither("repro_torch.launch.bus_server")


def test_procs_import_pulls_in_neither():
    _import_pulls_in_neither("repro_torch.launch.procs")


def test_procs_cli_runs_as_a_process_of_its_own(tmp_path):
    """``python -m repro_torch.launch.procs --help`` lists the four roles
    and exits 0 within 20 s; the process is killed and waited for, whatever
    happens."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.procs", "--help"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=20.0)
    finally:
        proc.kill()
        proc.wait(timeout=20.0)
    assert proc.returncode == 0, err
    assert "--role" in out and "{driver,executor,standby,voters}" in out


def test_bus_server_runs_as_a_process_of_its_own(tmp_path):
    """``python -m repro_torch.launch.bus_server`` over SQLite on port 0
    publishes its port; a port ``NetBus`` appends and reads back. The
    process is killed and waited for, whatever happens."""
    from repro_torch.core import entries
    from repro_torch.core.netbus import NetBus

    port_file = tmp_path / "bus.port"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.bus_server",
         "--backend", "sqlite", "--path", str(tmp_path / "bus.db"),
         "--port", "0", "--port-file", str(port_file)],
        env=env, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    bus = None
    try:
        deadline = time.monotonic() + 20.0
        while not port_file.exists():
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < deadline, "no port file in 20 s"
            time.sleep(0.05)
        bus = NetBus(f"127.0.0.1:{port_file.read_text()}",
                     client_id="selfcontained", connect_timeout=10.0,
                     request_timeout=10.0)
        assert bus.append_many([entries.mail("over"),
                                entries.mail("tcp")]) == [0, 1]
        assert [e.body["text"] for e in bus.read(0)] == ["over", "tcp"]
        assert bus.tail(refresh=True) == 2
    finally:
        if bus is not None:
            bus.close()
        proc.kill()
        proc.wait(timeout=20.0)
        proc.stderr.close()
