"""chip_smoke.py and bench.py on the CPU: both refuse a non-GPU device
before printing a result, and chip_smoke's phases run end to end at a
tiny size (the card runs them at full width)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_bench_refuses_cpu(capsys):
    import bench

    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script exits non-zero and
    prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_one_card_phases_tiny():
    import chip_smoke as cs

    out = cs.run_one_card(cs.Sizes.tiny(), card="cpu (test)")
    assert out["parity"]["jaccard_min"] > 0.98
    assert out["ingest"]["hashes"] > 0
    assert out["recognize"]["clean"] == 1.0
    assert out["serve"]["errors"] == 0
    assert out["serve"]["requests"] >= cs.Sizes.tiny().serve_requests


def test_four_card_path_tiny():
    """The four-card path on 4 of the suite's virtual CPU devices."""
    import chip_smoke as cs

    out = cs.run_four_cards(cs.Sizes.tiny(), n_dev=4)
    assert out["key_range"]["clips"] == cs.Sizes.tiny().clips
    assert "all-reduce" in out["key_range"]["collectives"]
    assert "all-gather" in out["by_song"]["collectives"]
    assert "collective-permute" in out["seq_collectives"]
