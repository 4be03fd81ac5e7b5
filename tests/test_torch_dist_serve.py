"""The elastic server over four ranks through the serve CLI
(``--elastic --procs 4``) on the CPU: at temperature 0.8 the last stage
samples from the lane seeds, and the streams are bitwise the one-process
streams through a shrink at tick 2 and a grow at tick 4.  The serve over
four ranks against the reference (completions, the page pool after a
cycle) is ``test_torch_elastic.py``'s, which shares that file's reference
run.
"""
import torch

from repro_torch.launch.serve import run as serve_run

torch.set_num_threads(1)
CLI = ["--elastic", "--layers", "6", "--d-model", "64", "--num-heads", "4",
       "--num-kv-heads", "2", "--d-ff", "128", "--vocab-size", "256",
       "--stages", "4", "--micro", "2", "--mb-global", "2", "--prompt-len",
       "8", "--gen", "8", "--requests", "6", "--kv-page-size", "4",
       "--seed", "0", "--temperature", "0.8", "--device", "cpu"]


def test_sampling_streams_over_four_ranks_equal_one_process():
    across = serve_run(CLI + ["--procs", "4"], resize_at={2: 2, 4: 4})
    one = serve_run(CLI, resize_at={2: 2, 4: 4})
    streams = {c["rid"]: c["tokens"] for c in across["completions"]}
    assert streams == {c["rid"]: c["tokens"] for c in one["completions"]}
    assert len(streams) == 6 and all(streams.values())
    assert [(r["kind"], r["step"]) for r in across["resizes"]] == [
        (r["kind"], r["step"]) for r in one["resizes"]] == [
        ("shrink", 2), ("grow", 4)]
    assert [r["stage"] for r in across["ranks"]] == [0, 1, 2, 3]
    assert all(r["foreign_modules"] == [] for r in across["ranks"])

