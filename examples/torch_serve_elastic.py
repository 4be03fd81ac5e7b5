"""Elastic serving demo on the PyTorch/CUDA port: continuous batching +
load-driven autoscaling.

A bursty request trace (short early-exit requests around a long-generation
tail) is served twice through the ``Session`` API:

  * **elastic** — the autoscaler watches queue depth and KV-lane
    occupancy; when the burst drains it consolidates the serving pipeline
    (workers are released through the job-manager boundary), and when the
    second burst backs the queue up it grows back;
  * **fixed** — the same spec with ``cluster.autoscale`` off.

The generated tokens are asserted identical request for request: a resize
re-splits the in-flight KV caches across the new world bit-exactly, so
elasticity is invisible to the served requests — it only changes how many
workers were held while serving them.

    PYTHONPATH=src python examples/torch_serve_elastic.py [--device cpu]
"""
import argparse
import copy
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gen-long", type=int, default=24,
                    help="generation length of the long-tail requests")
    ap.add_argument("--job-manager", default="inproc",
                    choices=["inproc", "file"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.api import (ClusterSpec, ModelSpec, ParallelSpec,
                                 RunSpec, ServeSpec, Session)
    from repro_torch.serve.requests import Request

    spec = RunSpec(
        model=ModelSpec(arch="smollm-360m", layers=8, d_model=128,
                        d_ff=256),
        parallel=ParallelSpec(stages=4, num_micro=2, mb_global=2),
        cluster=ClusterSpec(job_manager=args.job_manager, autoscale=True),
        serve=ServeSpec(prompt_len=8, gen=args.gen_long, min_stages=2,
                        patience=2, cooldown=3, queue_high=2,
                        occupancy_low=0.6, defrag_every=4))

    # a hand-built long-tail trace (Session.serve takes an explicit trace
    # when the spec's make_trace distribution is not enough)
    rng = np.random.RandomState(0)
    vocab = spec.model.vocab_size

    def prompt(n):
        return rng.randint(0, vocab, n).astype(np.int32)

    trace = [Request(rid=i, arrival=0, prompt=prompt(8), gen=2 + i % 3,
                     kind="early_exit") for i in range(6)]
    trace += [Request(rid=6 + i, arrival=0, prompt=prompt(6),
                      gen=args.gen_long) for i in range(2)]
    t2 = args.gen_long + 14
    trace += [Request(rid=8 + i, arrival=t2 + i // 4, prompt=prompt(8),
                      gen=4) for i in range(6)]

    def serve(autoscale):
        sp = dataclasses.replace(
            spec, cluster=dataclasses.replace(
                spec.cluster,
                # the file job manager only matters when scaling releases
                # workers; keep the fixed baseline in-process
                job_manager=(args.job_manager if autoscale else "inproc"),
                autoscale=autoscale))
        with Session(sp, device=args.device) as s:
            return s.serve(trace=copy.deepcopy(trace))

    print("=== elastic (autoscaled) ===")
    el = serve(True)
    print("=== fixed ===")
    fx = serve(False)

    for a, b in zip(el["completions"], fx["completions"]):
        assert a["tokens"] == b["tokens"], (a["rid"], a["tokens"],
                                            b["tokens"])
    kinds = [(r["kind"], r["from_stages"], r["to_stages"])
             for r in el["resizes"]]
    released = sum(1 for e in el["pool_log"] if e.startswith("release:"))
    held = sum(el["stages_history"]) / len(el["stages_history"])
    print(f"\nserved {len(el['completions'])} requests, "
          f"{el['total_tokens']} tokens each run — identical token streams")
    print(f"elastic resizes: {kinds}; {released} workers released via the "
          f"job manager; mean workers held {held:.1f}/4 "
          f"(fixed run held 4.0/4)")
    return el, fx


if __name__ == "__main__":
    main()
