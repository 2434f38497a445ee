"""jepsen_tpu_torch stands alone: no module of it, and not chip_smoke.py,
imports jax or anything of jepsen_tpu, and no C or CUDA source of it
includes a file outside the package; without a card the default
device raises BackendUnavailable instead of running on the CPU, on the
deep route and on the segment route; shapes outside the slice raise
Unsupported."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu_torch import convert, models
from jepsen_tpu_torch.checker import Linearizable
from jepsen_tpu_torch.errors import BackendUnavailable, Unsupported
from jepsen_tpu_torch.history import History, info_op, invoke_op, ok_op
from jepsen_tpu_torch.ops import deep_kernel, wgl_cpu, wgl_deep, wgl_seg

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "jepsen_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
PACKAGE = ROOT / "jepsen_tpu_torch"
C_FILES = sorted(p for ext in ("*.c", "*.h", "*.cu")
                 for p in PACKAGE.rglob(ext) if "_build" not in p.parts)


def forbidden(name: str) -> bool:
    # "jepsen_tpu" as a substring would also match "jepsen_tpu_torch"
    return any(name == m or name.startswith(m + ".")
               for m in ("jax", "jaxlib", "jepsen_tpu"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(forbidden(n) for n in names), (path, names)


def test_import_pulls_in_no_forbidden_module():
    mods = sorted("jepsen_tpu_torch." + ".".join(
        p.relative_to(ROOT / "jepsen_tpu_torch").with_suffix("").parts)
        for p in FILES[:-1])
    mods = [m.removesuffix(".__init__") for m in mods]
    assert {"jepsen_tpu_torch.native", "jepsen_tpu_torch.independent"} \
        <= set(mods)
    code = ("import sys, importlib\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'jepsen_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'jepsen_tpu.'))]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_c_sources_are_the_packages_own():
    names = {p.name for p in C_FILES}
    assert {"histscan.c", "scancommon.h", "wgl_deep.cu", "wgl_regs.cu",
            "wgl_crash.cu"} <= names


@pytest.mark.parametrize("path", C_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_c_sources_include_nothing_outside_the_package(path):
    includes = re.findall(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]',
                          path.read_text(), re.M)
    assert includes, path
    for kind, name in includes:
        assert "jepsen" not in name and ".." not in name, name
        if kind == '"':
            # a quoted include is a file of the package, beside the source
            target = (path.parent / name).resolve()
            assert target.is_relative_to(PACKAGE) and target.exists(), name
        else:
            assert not name.startswith("/"), name


def small_history():
    return History([invoke_op(0, "write", 1), ok_op(0, "write", 1),
                    invoke_op(1, "read", None), ok_op(1, "read", 1)]
                   ).index()


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for the default device")

    monkeypatch.setattr(deep_kernel, "walk_plain", no_plain)
    launches = deep_kernel.LAUNCHES
    h = small_history()
    with pytest.raises(BackendUnavailable):
        Linearizable(models.CASRegister()).check(None, h)
    with pytest.raises(BackendUnavailable):
        wgl_seg.check(models.CASRegister(), h)
    with pytest.raises(BackendUnavailable):
        wgl_deep.check_pipeline(models.CASRegister(), [h])
    tables = convert.tables_to_device(
        [[0]], [[[0]]], [[[0]]], [1], [0], [0])
    with pytest.raises(BackendUnavailable):
        wgl_deep.check_tables(*tables, 1, 1)
    assert deep_kernel.LAUNCHES == launches


def test_segment_route_without_a_card_raises(monkeypatch):
    from jepsen_tpu_torch.ops import regs_kernel
    h = small_history()
    got = wgl_seg.check(models.CASRegister(), h, device="cpu")
    assert got["valid?"] is True and got["engine"] == "wgl_seg"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for the default device")

    monkeypatch.setattr(regs_kernel, "scan_plain", no_plain)
    launches = regs_kernel.LAUNCHES
    with pytest.raises(BackendUnavailable):
        wgl_seg.check_pipeline(models.CASRegister(), [h])
    with pytest.raises(BackendUnavailable):
        wgl_seg.check(models.CASRegister(), h)
    assert regs_kernel.LAUNCHES == launches


def test_unknown_device_type_raises():
    with pytest.raises(BackendUnavailable, match="meta"):
        wgl_seg.check(models.CASRegister(), small_history(), device="meta")


def test_crashed_history_raises_unsupported():
    # crashed calls have verdicts now (the crash tiers); only the
    # residual case, where every tier leaves the history open, raises in
    # wgl_seg.check, naming the serial engines, and the checker then
    # runs the serial frontier engine, as the reference's does
    h = History([invoke_op(0, "write", 1), info_op(0, "write", 1),
                 invoke_op(1, "read", None), ok_op(1, "read", 1)]).index()
    r = Linearizable(models.CASRegister(), device="cpu").check(None, h)
    assert r["valid?"] is True and r["crashed"] == 1
    unreturned = History([invoke_op(0, "write", 1)]).index()
    r = wgl_seg.check(models.CASRegister(), unreturned, device="cpu")
    assert r["valid?"] is True and r["crashed_ignored"] == 1
    ops = [invoke_op(9, "write", 0), ok_op(9, "write", 0)]
    ops += [invoke_op(i, "write", i % 3 + 1) for i in range(6)]
    for i in range(6):
        ops += [invoke_op(9, "read", None), ok_op(9, "read", i % 3 + 1),
                invoke_op(8, "write", 0), ok_op(8, "write", 0)]
    ops += [info_op(i, "write", i % 3 + 1) for i in range(6)]
    residual = History(ops).index()
    with pytest.raises(Unsupported, match="P5"):
        wgl_seg.check(models.CASRegister(), residual, device="cpu")
    r = Linearizable(models.CASRegister(), device="cpu").check(None,
                                                               residual)
    assert r["engine"] == "wgl" and "P5" in r["dispatch"]["why"]
    assert r["valid?"] is wgl_cpu.check(models.CASRegister(),
                                        residual)["valid?"]


@pytest.mark.parametrize("depth", [11, 17])
def test_over_deep_history_raises_unsupported(depth):
    # past max_open_bits (11 at 10) or past the deep kernel (17): the
    # batched engines refuse it, and the checker's serial frontier
    # engine decides it
    ops = [invoke_op(p, "write", p % 3) for p in range(depth)]
    ops += [ok_op(p, "write", p % 3) for p in range(depth)]
    h = History(ops).index()
    bits = 10 if depth == 11 else 18
    with pytest.raises(Unsupported, match="P5"):
        wgl_seg.check(models.CASRegister(), h, device="cpu",
                      max_open_bits=bits)
    r = Linearizable(models.CASRegister(), device="cpu",
                     max_open_bits=bits).check(None, h)
    assert r["valid?"] is True and r["engine"] == "wgl"
    assert r["op_count"] == depth


def test_too_many_states_raises_unsupported():
    # 41 states: past the segment and deep kernels' 32, so the
    # candidate-table route decides it; past max_states it is refused
    ops = []
    for v in range(40):
        ops += [invoke_op(0, "write", v), ok_op(0, "write", v)]
    h = History(ops).index()
    r = wgl_seg.check(models.CASRegister(), h, device="cpu")
    assert r["valid?"] is True and r["states"] == 41
    assert r["dispatch"]["kernel"] == "wgl_cand_dense"
    with pytest.raises(Unsupported, match="max_states=32"):
        wgl_seg.check(models.CASRegister(), h, device="cpu", max_states=32)


def test_model_without_device_spec_raises_unsupported():
    class HostOnly(models.Model):
        def step(self, op):
            return self

    with pytest.raises(Unsupported, match="no device spec"):
        Linearizable(HostOnly(), device="cpu").check(None, small_history())
    got = Linearizable(HostOnly(), algorithm="cpu").check(
        None, small_history())
    assert got["valid?"] is True
