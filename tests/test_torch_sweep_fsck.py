"""``tools/torch_ckpt_fsck.py`` against ``tools/ckpt_fsck.py``: the same
defects — a torn step, a missing blob, orphaned blobs — in a port tree and
in a JAX tree built by the same sequence of saves give the same counts and
exit codes, in the single-tree and the shared-store (``--store``) modes.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dwt_tpu.ckpt import store as jax_store
from dwt_tpu_torch.ckpt import store
from dwt_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


OURS, REF = _tool("torch_ckpt_fsck"), _tool("ckpt_fsck")
COUNTS = ("valid_candidates", "torn_candidates", "blobs_on_disk", "store_bytes",
          "blobs_referenced", "blobs_missing", "blobs_orphaned", "reclaimable_bytes")
CANDIDATE = ("kind", "step", "path", "format", "valid", "chain_depth", "chain_base_step")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _leaves(step, offset=0):
    """Four leaves: ``a`` moves at 2, 3 and 5, ``b`` at 3, ``c`` at 5."""
    moves = {"a": (2, 3, 5), "b": (3,), "c": (5,), "d": ()}
    return {k: np.full((3, 4), sum(s <= step for s in at) + offset, np.float32) + 10 * i
            for i, (k, at) in enumerate(moves.items())}


def _host(arrays, step):
    payload = {"model": {k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
               "optimizer": {"state": {}, "param_groups": [{"lr": 0.1, "params": []}]},
               "step": step, "lr_scale": 1.0}
    return ckpt.HostState(payload, tuple(arrays))


def _save(name, root, step, offset=0, store_root=None):
    arrays = _leaves(step, offset)
    if name == "ours":
        return store.save_delta(root, step, _host(arrays, step), store_root=store_root,
                                delta_max_chain=3, gc=False)
    return jax_store.save_delta(root, step, {"params": arrays}, store_root=store_root,
                                delta_max_chain=3, gc=False)


def _orphan(blobs, digest, size):
    os.makedirs(os.path.join(blobs, digest[:2]), exist_ok=True)
    with open(os.path.join(blobs, digest[:2], digest + ".bin"), "wb") as f:
        f.write(b"x" * size)


def _summary(report):
    out = {k: report[k] for k in COUNTS}
    runs = report.get("runs", [report])
    out["candidates"] = [[{k: c.get(k) for k in CANDIDATE} for c in r["candidates"]]
                         for r in runs]
    # The leaf paths' roots differ (the port's state dict, the JAX tree).
    out["reasons"] = sorted(re.sub(r" for leaf \S+", "", c["reason"].split(" at ")[0])
                            for r in runs for c in r["candidates"] if c["reason"])
    out["tmp_stages"] = [r["tmp_stages"] for r in runs]
    out["new_blobs_referenced"] = [r.get("new_blobs_referenced") for r in runs]
    return out


def _run(tool, argv, capsys):
    rc = tool.main(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_defects_of_a_port_tree_report_as_the_jax_trees(tmp_path, capsys):
    """Saves 1–5 (full at 1 and 5, deltas between); then the step-4
    manifest torn, the blob only step 3 added deleted, two orphans and
    an unpromoted stage."""
    got = {}
    for name in ("ours", "jax"):
        root = str(tmp_path / name)
        for step in range(1, 6):
            _save(name, root, step)
        clean = _run(OURS if name == "ours" else REF, [root, "--json"], capsys)
        with open(os.path.join(root, "4", "manifest.json"), "w") as f:
            f.write("{torn")
        m3 = json.load(open(os.path.join(root, "3", "manifest.json")))
        m2 = json.load(open(os.path.join(root, "2", "manifest.json")))
        only3 = sorted({e["digest"] for e in m3["leaves"]} - {e["digest"] for e in m2["leaves"]})
        os.remove(os.path.join(root, "blobs", only3[0][:2], only3[0] + ".bin"))
        _orphan(os.path.join(root, "blobs"), "ab" * 32, 17)
        _orphan(os.path.join(root, "blobs"), "cd" * 32, 5)
        os.makedirs(os.path.join(root, ".tmp-cas-9"))
        got[name] = (clean, _run(OURS if name == "ours" else REF, [root, "--json"], capsys))
    (ours_clean, ours), (ref_clean, ref) = got["ours"], got["jax"]
    assert ours_clean[0] == ref_clean[0] == 0
    assert _summary(ours_clean[1]) == _summary(ref_clean[1])
    assert ours[0] == ref[0] == 1
    assert _summary(ours[1]) == _summary(ref[1])
    report = ours[1]
    assert report["torn_candidates"] == 2 and report["blobs_missing"] == 1
    assert report["blobs_orphaned"] == 2 and report["reclaimable_bytes"] == 22
    assert report["tmp_stages"] == [".tmp-cas-9"]
    assert {c["step"]: c["valid"] for c in report["candidates"]} == {
        1: True, 2: True, 3: False, 4: False, 5: True}


def test_store_mode_counts_a_siblings_blobs_as_referenced(tmp_path, capsys):
    """Two runs refcount into one store: a blob only the second run
    references is not an orphan of the union; one no run references is."""
    got = {}
    for name in ("ours", "jax"):
        base = tmp_path / name
        blobs = str(base / "blobs")
        runs = [str(base / "A2B" / "ckpt"), str(base / "B2A" / "ckpt")]
        for i, run in enumerate(runs):
            for step in (1, 2, 3):
                _save(name, run, step, offset=100 * i, store_root=blobs)
        _orphan(blobs, "ef" * 32, 9)
        tool = OURS if name == "ours" else REF
        single = _run(tool, [runs[0], "--json"], capsys)
        union = _run(tool, ["--store", blobs, *runs, "--json"], capsys)
        got[name] = (single, union)
    (o_single, o_union), (r_single, r_union) = got["ours"], got["jax"]
    assert o_union[0] == r_union[0] == 0
    assert _summary(o_union[1]) == _summary(r_union[1])
    assert o_union[1]["blobs_orphaned"] == 1 and o_union[1]["blobs_missing"] == 0
    assert o_union[1]["blobs_referenced"] == o_union[1]["blobs_on_disk"] - 1
    # Alone, a run's tree accounts only for its own (absent) local store.
    assert _summary(o_single[1]) == _summary(r_single[1])
    assert o_single[1]["blobs_on_disk"] == 0


def test_usage_errors_exit_2_as_jax(tmp_path, capsys):
    for argv in ([str(tmp_path / "nope")], [str(tmp_path), str(tmp_path)],
                 ["--store", str(tmp_path / "nope"), str(tmp_path)]):
        assert OURS.main(argv) == REF.main(argv) == 2
    capsys.readouterr()


def test_a_torn_full_format_step_and_the_cli_without_torch(tmp_path):
    """The port's ``torch_full`` format: a truncated ``state.pt`` is torn
    (the validity authority's size check); the tool runs as a script
    without importing torch or JAX."""
    root = str(tmp_path / "ck")
    for step in (3, 6):
        ckpt.save_state(root, step, _host(_leaves(step), step))
    state = os.path.join(root, "6", ckpt.STATE_FILE)
    with open(state, "r+b") as f:
        f.truncate(os.path.getsize(state) // 2)
    code = ("import json, runpy, sys\n"
            f"sys.argv = ['fsck', {root!r}, '--json']\n"
            "try:\n"
            "    runpy.run_path('tools/torch_ckpt_fsck.py', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "print(rc, sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'dwt_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report_line, tail = out.stdout.strip().splitlines()
    assert tail == "1 []"
    report = json.loads(report_line)
    assert [(c["step"], c["format"], c["valid"]) for c in report["candidates"]] == [
        (3, "torch_full", True), (6, "torch_full", False)]
    assert "truncated" in report["candidates"][1]["reason"]
