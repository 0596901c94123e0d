"""Port parity, cli/flex.py --q_batch --shard_q on the CPU: two gloo
ranks of a launcher (python -m torch.distributed.run) against one
--q_batch process, then a q batch that does not divide over the ranks,
then --shard_q off the batched path (no --q_batch; --write_stream),
which the JAX CLI takes and leaves unused.
The JSONs must agree key for key: rates rel 1e-5, PSNR 1e-4 dB,
everything else but wall times equal. Each rank runs two threads.
"""

import json

from test_torch_port_parallel_cli import _finish, _start

RATE_REL, PSNR_ABS = 1e-5, 1e-4


FLEX = ["-m", "learned_pmctf_tpu_torch.cli.flex", "--synthetic", "4",
        "--synthetic_size", "64x64", "--num_me_stages", "2", "--features", "16",
        "--ar_features", "16", "--channel_mv", "16", "--decomp_levels", "2",
        "--device", "cpu", "--q_batch"]
LAUNCH = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2"]


def _jsons(out_dir):
    return {p.name: json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))}


def _same_json(got, want, where=()):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            if "time" not in k:
                _same_json(got[k], want[k], where + (k,))
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same_json(a, b, where + (i,))
    elif isinstance(want, float):
        key = " ".join(str(w) for w in where)
        if "psnr" in key:
            assert abs(got - want) <= PSNR_ABS, (where, got, want)
        else:
            assert abs(got - want) <= RATE_REL * max(abs(want), 1e-6), (where, got, want)
    else:
        assert got == want, (where, got, want)


def test_flex_shard_q_matches_q_batch(tmp_path):
    """A GOP-4 at q 0, 6, 12, 20 (four elements): two gloo ranks of two
    rate points each against one --q_batch process; rank 0 alone writes
    the same files with the same keys and numbers."""
    args = FLEX + ["--force_intra_period", "4", "--q_index_num", "4"]
    procs = {"batch": _start(args + ["--output_path", str(tmp_path / "batch" / "out.json")],
                             tmp_path),
             "shard": _start(LAUNCH + args + ["--shard_q", "--output_path",
                                              str(tmp_path / "shard" / "out.json")], tmp_path)}
    outs = {k: _finish(p) for k, p in procs.items()}
    assert "q_batch sharded: 1 seqs x 4 rate points over 2 ranks" in outs["shard"]
    assert outs["shard"].count("wrote ") == 4  # rank 0's four per-q files
    batch, shard = _jsons(tmp_path / "batch"), _jsons(tmp_path / "shard")
    assert sorted(batch) == ["out_qidx0.json", "out_qidx12.json", "out_qidx20.json",
                             "out_qidx6.json", "out_summary.json"]
    _same_json(shard, batch)
    bpp = batch["out_summary.json"]["bpp"]
    assert len(set(bpp)) == 4  # the rate points differ


def test_flex_shard_q_falls_back_when_the_batch_does_not_divide(tmp_path):
    """A GOP-2 at three rate points on two ranks: 3 elements do not
    divide over 2, so rank 0 codes them as --q_batch and says so, and
    writes what --q_batch writes."""
    args = FLEX + ["--force_intra_period", "2", "--synthetic", "2", "--q_index_num", "3"]
    procs = {"batch": _start(args + ["--output_path", str(tmp_path / "batch" / "out.json")],
                             tmp_path),
             "shard": _start(LAUNCH + args + ["--shard_q", "--output_path",
                                              str(tmp_path / "shard" / "out.json")], tmp_path)}
    outs = {k: _finish(p) for k, p in procs.items()}
    assert ("q_batch not sharded: 3 elements do not divide over more than one of 2 ranks"
            in outs["shard"])
    assert "sharded:" not in outs["shard"].replace("not sharded:", "")
    _same_json(_jsons(tmp_path / "shard"), _jsons(tmp_path / "batch"))


def test_flex_shard_q_off_the_batched_path_is_unused(tmp_path):
    """--shard_q where no q batch is coded, as test_pmctf_flex.py takes
    it: without --q_batch, and with --write_stream (its streams coded one
    rate point at a time). On two ranks of a launcher rank 0 codes, says
    the shard is unused, and writes the JSON of the same run without
    --shard_q."""
    base = [a for a in FLEX if a != "--q_batch"] + [
        "--force_intra_period", "2", "--synthetic", "2", "--q_index_num", "2"]
    runs = {"plain": base, "stream": base + ["--q_batch", "--write_stream", "1"]}
    procs = {}
    for name, args in runs.items():
        for shard in (False, True):
            out = tmp_path / f"{name}{int(shard)}"
            extra = ["--output_path", str(out / "out.json"), "--stream_path", str(out / "bin")]
            procs[name, shard] = _start((LAUNCH if shard else []) + args + extra
                                        + (["--shard_q"] if shard else []), tmp_path)
    outs = {k: _finish(p) for k, p in procs.items()}
    assert ("shard_q unused: no q batch (--q_batch with more than one q index, or "
            "--seq_batch); rank 0 codes as without --shard_q") in outs["plain", True]
    assert ("shard_q unused: --write_stream codes one rate point at a time"
            in outs["stream", True])
    for name in runs:
        assert outs[name, True].count("wrote ") == 2  # rank 0's per-q files
        shard, alone = _jsons(tmp_path / f"{name}1"), _jsons(tmp_path / f"{name}0")
        assert sorted(shard) == sorted(alone) and len(alone) == 3
        _same_json(shard, alone)
