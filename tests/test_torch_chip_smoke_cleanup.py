"""chip_smoke.py stops every process it started before it exits: a child
never waited for, an orphan whose parent ended first, and multiprocessing's
resource tracker (started by any ``spawn``-context process, as the recipe's
feature workers and the spawned ranks start it)."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import json, multiprocessing as mp, subprocess, sys, time
    sys.path.insert(0, sys.argv[1])
    import chip_smoke

    def work():
        pass

    if __name__ == "__main__":
        chip_smoke.adopt_orphans()
        ctx = mp.get_context("spawn")
        p = ctx.Process(target=work)
        p.start()
        p.join()
        from multiprocessing import resource_tracker
        tracker = resource_tracker._resource_tracker._pid
        orphan = int(subprocess.run(["sh", "-c", "sleep 300 > /dev/null 2>&1 & echo $!"],
                                    capture_output=True, text=True).stdout)
        unwaited = subprocess.Popen(["sleep", "300"]).pid
        time.sleep(0.2)
        stopped = chip_smoke.stop_leftovers()
        print(json.dumps({"pids": [tracker, orphan, unwaited], "stopped": stopped,
                          "again": chip_smoke.stop_leftovers()}))
""")


def _running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="needs /proc and prctl")
def test_stop_leftovers_ends_every_child(tmp_path):
    script = tmp_path / "leftovers.py"
    script.write_text(SCRIPT)
    out = subprocess.run([sys.executable, str(script), ROOT], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    tracker, orphan, unwaited = got["pids"]
    assert tracker is not None
    assert sum(s == "sleep 300" for s in got["stopped"]) == 2
    assert any("resource tracker" in s for s in got["stopped"])
    assert got["again"] == []
    assert not any(_running(p) for p in got["pids"])
