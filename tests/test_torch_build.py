"""PyTorch port: the kernel build (``ops/_build.py``) on the CPU, with a
stand-in for nvcc that records its calls.

A source that defines ``DSST_PARTS n`` compiles as n units, one process
each with ``-DDSST_PART=k``, and one link of their objects in unit order;
a failing unit raises with its output and leaves no library behind.
"""
import os
import stat
import sys

import pytest

from deepspeedsyclsupport_tpu_torch.ops import _build

FAKE_NVCC = f"""#!{sys.executable}
import os, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    unit = next(a for a in args if a.startswith("-DDSST_PART="))[12:]
    print(f"ptxas info    : Compiling entry function 'unit{{unit}}'")
    if os.environ.get("FAKE_NVCC_FAIL") == unit:
        print(f"unit {{unit}}: error")
        sys.exit(2)
    open(out, "w").write(f"object {{unit}}\\n")
else:
    objs = [a for a in args if a.endswith(".o")]
    open(out, "w").write("".join(open(o).read() for o in objs))
    print("linked", len(objs))
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n#define DSST_PARTS 3\n")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_units_compile_apart_and_link_in_order(fake):
    built = _build.build("k")
    assert built.path.read_text() == "object 0\nobject 1\nobject 2\n"
    assert all(f"entry function 'unit{k}'" in built.log for k in range(3))
    assert "linked 3" in built.log and built.seconds > 0
    # the units' objects went with their private directory
    assert sorted(os.listdir(fake / "build")) == sorted(
        [built.path.name, built.path.with_suffix(".log").name])
    again = _build.build("k")        # this source was built: reused
    assert again.path == built.path and again.seconds == 0.0


def test_a_failing_unit_raises_with_its_output(fake, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="unit 1") as err:
        _build.build("k")
    assert "unit 1: error" in str(err.value)
    assert not list((fake / "build").glob("*.so"))


def test_a_source_without_parts_is_one_unit(fake):
    (fake / "csrc" / "k.cu").write_text("// one unit\n")
    assert _build.build("k").path.read_text() == "object 0\n"
