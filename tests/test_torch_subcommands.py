"""The port's `process`, `analyse` and `cluster-validate` subcommands
against the JAX package's, on the CPU, over a synthetic corpus (16
genomes in 4 families): every output byte-identical to the JAX CLI's.

- process and analyse with precomputed inputs (a CheckM2 quality report,
  barrnap GFF and tRNAscan-SE lists), and with the mock checkm2, barrnap
  and tRNAscan-SE of tests/test_process_mock.py on PATH; process injects
  the quality report into clustering, so the representatives follow it;
- cluster-validate over a correct clusters.tsv ("no problems") and over
  one that splits a family and joins two (the same problems, counted
  and logged as in the JAX package).
"""

import os
import re

import pytest

from galah_tpu.cli.main import main as jax_main
from galah_tpu.cli.main import build_parser as jax_parser
from galah_tpu.cli.validate_cmd import run_validate as jax_validate
from galah_tpu.utils.synth import make_families
from galah_tpu_torch.cli.main import build_parser
from galah_tpu_torch.cli.main import main as torch_main
from galah_tpu_torch.cli.validate_cmd import run_validate

AAS = ["Ala", "Arg", "Asn", "Asp", "Cys", "Gln", "Glu", "Gly", "His", "Ile",
       "Leu", "Lys", "Met", "Phe", "Pro", "Ser", "Thr", "Trp", "Tyr", "Val"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("sub_corpus")
    paths, fams = make_families(str(d), 4, 4, genome_length=30_000,
                                within_ani=0.98, seed=5)
    return paths, fams


def _rows(paths):
    """(stem, completeness, contamination, 5S, 16S, 23S, tRNAs) per
    genome: the last member of each family scores best, and a few are
    of high quality."""
    rows = []
    for i, p in enumerate(paths):
        stem = os.path.splitext(os.path.basename(p))[0]
        rows.append((stem, 62.0 + 2.0 * i, 2.0, i % 2, 1, 1, 12 + i % 9))
    return rows


def _precomputed(paths, d):
    """Flags of a CheckM2 report, a barrnap GFF list and a tRNAscan-SE
    list written for `paths` under `d`."""
    os.makedirs(d, exist_ok=True)
    report = os.path.join(d, "quality_report.tsv")
    gffs = os.path.join(d, "gffs.tsv")
    trnas = os.path.join(d, "trnas.tsv")
    with open(report, "w") as q, open(gffs, "w") as g, open(trnas, "w") as t:
        q.write("Name\tCompleteness\tContamination\tModel\n")
        for p, (stem, comp, cont, r5, r16, r23, nt) in zip(paths,
                                                          _rows(paths)):
            q.write(f"{stem}\t{comp}\t{cont}\tGB\n")
            gff = os.path.join(d, f"{stem}.gff")
            with open(gff, "w") as f:
                f.write("##gff-version 3\n")
                for n, name in ((r5, "5S"), (r16, "16S"), (r23, "23S")):
                    f.writelines(f"c1\tbarrnap:0.9\trRNA\t1\t9\t0\t+\t.\t"
                                 f"Name={name}_rRNA;product=x\n"
                                 for _ in range(n))
            out = os.path.join(d, f"{stem}.trna.out")
            with open(out, "w") as f:
                f.write("h\nh\nh\n")
                f.writelines(f"c1\t{j + 1}\t1\t70\t{aa}\tNNN\t0\t0\t50.0\n"
                             for j, aa in enumerate(AAS[:nt]))
            g.write(f"{p}\t{gff}\n")
            t.write(f"{p}\t{out}\n")
    return ["--barrnap-gff-list", gffs, "--trnascan-out-list", trnas], report


def _both(argv_of, tmp_path, monkeypatch, outputs):
    """Run both CLIs on argv_of(out_dir); the bytes of each named output
    of each, after checking they are equal."""
    monkeypatch.setenv("GALAH_TPU_SCREEN", "packed")
    monkeypatch.setenv("GALAH_TPU_VERIFY_DEVICES", "1")
    got = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        if name == "torch":
            monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
        else:
            monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
        d = tmp_path / name
        d.mkdir()
        assert main(argv_of(str(d))) == 0
        got[name] = {o: (d / o).read_bytes() for o in outputs}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _clusters(tsv: bytes, paths, fams):
    fam_of = dict(zip(paths, fams))
    members = {}
    for line in tsv.decode().splitlines():
        rep, m = line.split("\t")
        members.setdefault(rep, []).append(m)
    for ms in members.values():
        assert len({fam_of[m] for m in ms}) == 1
    return members


@pytest.mark.parametrize("how", ["precomputed", "mock-tools"])
def test_process_matches_jax_package(corpus, tmp_path, monkeypatch, how):
    paths, fams = corpus
    if how == "precomputed":
        flags, report = _precomputed(paths, str(tmp_path / "inputs"))
        flags += ["--checkm2-quality-report", report]
    else:
        from test_process_mock import setup_mock_bin

        bindir = tmp_path / "bin"
        bindir.mkdir()
        setup_mock_bin(str(bindir), _rows(paths))
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
        monkeypatch.setenv("CHECKM2DB", str(tmp_path / "db"))
        flags = []

    def argv(d):
        return ["process", "-f", *paths, "--ani", "95", "-q",
                "--output-mimag-summary", f"{d}/mimag.tsv",
                "--output-quality-report", f"{d}/quality.tsv",
                "--output-cluster-definition", f"{d}/clusters.tsv", *flags]

    outs = ["mimag.tsv", "clusters.tsv"]
    if how == "mock-tools":
        outs.append("quality.tsv")
    out = _both(argv, tmp_path, monkeypatch, outs)
    members = _clusters(out["clusters.tsv"], paths, fams)
    assert len(members) == 4
    # The injected report ranks the last member of each family first.
    assert sorted(members) == sorted(
        paths[max(i for i, f in enumerate(fams) if f == fam)]
        for fam in set(fams))
    lines = out["mimag.tsv"].decode().splitlines()
    assert len(lines) == 1 + len(paths)
    assert {ln.split("\t")[-1] for ln in lines[1:]} == {"Medium quality",
                                                        "High quality"}


@pytest.mark.parametrize("how", ["precomputed", "mock-tools"])
def test_analyse_matches_jax_package(corpus, tmp_path, monkeypatch, how):
    paths, _ = corpus
    if how == "precomputed":
        flags, report = _precomputed(paths, str(tmp_path / "inputs"))
        flags += ["--checkm2-quality-report", report]
    else:
        from test_process_mock import setup_mock_bin

        bindir = tmp_path / "bin"
        bindir.mkdir()
        setup_mock_bin(str(bindir), _rows(paths))
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
        flags = ["--checkm2-db-path", str(tmp_path / "db")]
    out = _both(lambda d: ["analyse", "-f", *paths, "-q",
                           "--output-mimag-summary", f"{d}/mimag.tsv",
                           *flags],
                tmp_path, monkeypatch, ["mimag.tsv"])
    lines = out["mimag.tsv"].decode().splitlines()
    assert lines[0].startswith("genome\tcompleteness")
    assert [ln.split("\t")[0] for ln in lines[1:]] == paths


def _validate_file(paths, fams, path, broken):
    """A cluster file of the families; `broken` splits family 0 and
    puts family 2's members under family 1's representative."""
    clusters = {}
    for p, f in zip(paths, fams):
        if broken and f == 2:
            f = 1
        if broken and f == 0 and p != paths[fams.index(0)]:
            f = "0b"
        clusters.setdefault(f, []).append(p)
    with open(path, "w") as out:
        for members in clusters.values():
            out.writelines(f"{members[0]}\t{m}\n" for m in members)


@pytest.mark.parametrize("broken", [False, True])
def test_cluster_validate_matches_jax_package(corpus, tmp_path, monkeypatch,
                                              capsys, broken):
    paths, fams = corpus
    cluster_file = str(tmp_path / "clusters.tsv")
    _validate_file(paths, fams, cluster_file, broken)
    argv = ["cluster-validate", "--cluster-file", cluster_file, "--ani", "95",
            "--min-aligned-fraction", "15", "-t", "2"]
    problems, logs = [], []
    for parse, run, platform in ((jax_parser, jax_validate, None),
                                 (build_parser, run_validate, "cpu")):
        if platform:
            monkeypatch.setenv("GALAH_TPU_PLATFORM", platform)
        else:
            monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
        capsys.readouterr()
        problems.append(run(parse().parse_args(argv)))
        err = capsys.readouterr().err
        logs.append([re.sub(r"^\[[^]]*\] ", "", ln) for ln in err.splitlines()
                     if "ERROR" in ln or "Validation" in ln])
    assert problems[0] == problems[1]
    assert logs[0] == logs[1]
    if broken:
        # The split family's representatives and the joined families'
        # members are each a problem.
        assert problems[1] >= 2
        assert logs[1][-1].endswith(f"Validation found {problems[1]} problems")
    else:
        assert problems[1] == 0
        assert logs[1] == ["INFO: Validation found no problems"]
    # Through the CLI the port exits 0 either way, as the JAX package.
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
    assert torch_main(argv + ["-q"]) == 0


def test_subcommands_registered_as_in_jax_package():
    def subcommands(parser):
        action = next(a for a in parser._actions
                      if a.dest == "subcommand")
        return {name: sorted(a.dest for a in p._actions)
                for name, p in action.choices.items()}

    assert subcommands(build_parser()) == subcommands(jax_parser())
