"""The port over several processes: 2 and 4 processes joined by
torch.distributed over gloo on localhost (parallel/mesh.py), each with
2 CPU shards, run

- the planted-pairs screen of tests/mp_screen_worker.py: the sharded
  and the row-sharded triangle must find exactly the planted pairs in
  every process, with the single-process sweep's pairs and ANI;
- the end-to-end cluster_genomes of tests/mp_verify_worker.py (3
  families x 3 x 30 kb, seed 7): sketches partitioned and exchanged,
  the sharded screen and the partitioned verify. Every process must
  recover the families with the single-process run's clusters.

The workers are this file run as a script:
    python test_torch_multiprocess.py <mode> <rank> <nprocs> <port> [dir]
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Seconds a worker may take, and a collective may wait for its peers.
WORKER_TIMEOUT_S = 240
COLLECTIVE_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(mode: str, nprocs: int, *extra: str):
    """Start nprocs workers, wait for all of them (killing every one
    still running once one fails or the time is up) and return their
    outputs; fails unless each exited 0."""
    port = str(_free_port())
    env = dict(os.environ, GALAH_TPU_PLATFORM="cpu", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(nprocs), port, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, f"worker failed:\n{out}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _result(out: str, tag: str) -> dict:
    """The JSON a worker printed after `tag`."""
    line = next(ln for ln in out.splitlines() if ln.startswith(tag))
    return json.loads(line[len(tag):])


def _screen_test(nprocs: int) -> None:
    outs = _run_workers("screen", nprocs)
    got = [_result(o, "MP_SCREEN ") for o in outs]
    assert [g["rank"] for g in got] == list(range(nprocs))
    for g in got:
        assert g["shards"] == 2 * nprocs
        assert g["pairs"] == 50


def test_two_process_sharded_screen():
    _screen_test(2)


def test_four_process_sharded_screen():
    _screen_test(4)


def _families(tmp_path):
    from galah_tpu_torch.utils.synth import make_families

    corpus = tmp_path / "corpus"
    make_families(str(corpus), n_families=3, members_per_family=3,
                  genome_length=30_000, within_ani=0.97, seed=7)
    return str(corpus)


def _clusters_tsv(res) -> str:
    return "".join(f"{c[0]}\t{m}\n" for c in res.memberships() for m in c)


def _single_process_tsv(corpus: str) -> str:
    import torch

    from galah_tpu_torch import api

    return _clusters_tsv(api.cluster_genomes(
        _corpus_paths(corpus), api.ClusterParameters(threads=2),
        device=torch.device("cpu")))


def _corpus_paths(corpus: str):
    return sorted(os.path.join(corpus, f) for f in os.listdir(corpus)
                  if f.endswith(".fna"))


def _e2e_test(tmp_path, nprocs: int) -> None:
    corpus = _families(tmp_path)
    outs = _run_workers("e2e", nprocs, corpus)
    want = _single_process_tsv(corpus)
    for rank, out in enumerate(outs):
        got = _result(out, "MP_E2E ")
        assert got["rank"] == rank and got["families_exact"]
        assert got["clusters_tsv"] == want
        assert got["genomes_sketched"] == len(range(rank, 9, nprocs))
        assert got["verify_mp_pairs_local"] > 0
    assert any(f"exchanging across {nprocs} processes" in o for o in outs), \
        "the multi-process sketch partition never ran"


def test_two_process_end_to_end_clusters(tmp_path):
    _e2e_test(tmp_path, 2)


def test_four_process_end_to_end_clusters(tmp_path):
    _e2e_test(tmp_path, 4)


# ------------------------------------------------------------------ workers


def _worker_screen() -> dict:
    """tests/mp_screen_worker.py's screen: 3000 random rows of 16 words
    with 50 planted duplicate pairs, block 512."""
    import numpy as np
    import torch

    from galah_tpu_torch.ops.prefilter import screen_triangle_packed
    from galah_tpu_torch.parallel.distance import (
        sharded_screen_triangle_packed,
        sharded_screen_triangle_rowsharded,
    )
    from galah_tpu_torch.parallel.mesh import shard_list

    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    n, w = 3000, 16
    x = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    for t in range(50):
        x[2 * t + 1] = x[2 * t]
    sizes = np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)
    want = sorted((2 * t, 2 * t + 1) for t in range(50))
    single = screen_triangle_packed(list(x), sizes, 15, 0.5, w * 32,
                                    device=cpu, block=512)
    for sweep in (sharded_screen_triangle_packed,
                  sharded_screen_triangle_rowsharded):
        res = sweep(list(x), sizes, 15, 0.5, w * 32, devices=[cpu, cpu],
                    block=512)
        assert sorted(map(tuple, res.pairs.tolist())) == want, sweep
        o1 = np.lexsort((res.pairs[:, 1], res.pairs[:, 0]))
        o2 = np.lexsort((single.pairs[:, 1], single.pairs[:, 0]))
        assert np.array_equal(res.ani_est[o1].view(np.int32),
                              single.ani_est[o2].view(np.int32)), sweep
    return {"pairs": len(want), "shards": len(shard_list([cpu, cpu]))}


def _worker_e2e(corpus: str, rank: int) -> dict:
    import logging
    import re

    import torch

    from galah_tpu_torch import api
    from galah_tpu_torch.utils import metrics

    logging.basicConfig(level=logging.INFO)
    paths = _corpus_paths(corpus)
    m = metrics.reset()
    res = api.cluster_genomes(paths, api.ClusterParameters(threads=2),
                              device=[torch.device("cpu")] * 2)
    fams = [re.match(r"fam(\d+)_", os.path.basename(p)).group(1)
            for p in paths]
    want = sorted(sorted(i for i, f in enumerate(fams) if f == g)
                  for g in sorted(set(fams)))
    return {
        "families_exact": sorted(sorted(c) for c in res.clusters) == want,
        "clusters_tsv": _clusters_tsv(res),
        "genomes_sketched": m.counters.get("genomes_sketched"),
        "verify_mp_pairs_local": m.counters.get("verify_mp_pairs_local", 0),
    }


def _worker_main(argv) -> None:
    mode, rank, nprocs, port = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, REPO)
    import torch

    from galah_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(2)
    initialize_distributed(f"localhost:{port}", nprocs, rank,
                           timeout_s=COLLECTIVE_TIMEOUT_S)
    out = (_worker_screen() if mode == "screen"
           else _worker_e2e(argv[4], rank))
    out["rank"] = rank
    print(f"MP_{mode.upper()} " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
