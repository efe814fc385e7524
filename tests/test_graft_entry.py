"""``__graft_entry__.dryrun_multichip`` on four virtual CPU devices that
this test sets up itself: the function uses the devices JAX was started
with and sets no platform of its own."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_on_four_cpu_devices():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import jax, __graft_entry__ as g; "
            "assert len(jax.devices()) == 4; g.dryrun_multichip(4)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dryrun_multichip ok: 4 devices" in out.stdout
