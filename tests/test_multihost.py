"""Multi-host dress rehearsal: two local processes over
loopback exercise parallel/multihost.py end-to-end — jax.distributed
initialize, global sharded pixel arrays, shard_map render, cross-process
allgather — and the 2-process image must match a single-process render."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
CORNELL = REPO / "scenes" / "cornell.pbrt"

CHILD = """
import sys, json
import numpy as np
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from curry_pbrt_tpu.parallel.multihost import render_distributed
pid = int(sys.argv[1])
img = render_distributed(
    {scene!r},
    overrides={{"resolution": (32, 32), "spp": 2, "max_depth": 2}},
    coordinator={coord!r}, num_processes=2, process_id=pid,
    output={out!r} + "/mh_test_out.png",
)
np.save({out!r} + f"/mh_test_img_{{pid}}.npy", img)
print("CHILD_OK", pid)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(600)
def test_two_process_render_matches_single(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    code = CHILD.format(repo=str(REPO), scene=str(CORNELL), coord=coord,
                        out=str(tmp_path))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"child failed:\n{out}\n{err[-2000:]}"
        assert "CHILD_OK" in out

    img0 = np.load(tmp_path / "mh_test_img_0.npy")
    img1 = np.load(tmp_path / "mh_test_img_1.npy")
    # both processes hold the SAME full film after allgather
    np.testing.assert_array_equal(img0, img1)

    # single-process render through the same path
    from curry_pbrt_tpu.parallel.multihost import render_distributed

    single = render_distributed(
        CORNELL,
        overrides={"resolution": (32, 32), "spp": 2, "max_depth": 2},
        num_processes=1, process_id=0, output=str(tmp_path / "mh_test_single.png"),
    )
    np.testing.assert_allclose(img0, np.asarray(single), atol=1e-6)
