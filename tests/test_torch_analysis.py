"""The port's analysis plane (``repro_torch.analysis``), tested in both
directions, case for case with ``repro``'s ``tests/test_analysis.py``.

Static passes: every rule of the catalogue trips on its seeded fixture
(``tests/torch_analysis_fixtures/``, the PyTorch idiom of ``repro``'s
corpus), every clean exemplar stays quiet, the suppression and baseline
machinery behaves, and the port's shipped tree is clean under
``--strict``.

Runtime sentinels: the host-read and recompile sentinels count what a
run does, and the continuous-batching scheduler's steady state — block
steps between admission and retirement on a warmed scheduler — reads the
host zero times and compiles nothing; the retirement wave is its one
read, which the scheduler's own ``host_transfers`` counts too.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import cli, runtime, tags
from repro_torch.kernels import _build

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_analysis_fixtures")
SRC = os.path.join(HERE, os.pardir, "src", "repro_torch")


@pytest.fixture(scope="module")
def corpus():
    return cli.analyze_paths([FIXTURES])


def _rules_by_file(findings):
    out = {}
    for f in findings:
        name = os.path.relpath(f.path, FIXTURES)
        out.setdefault(name, []).append(f.rule)
    return {k: sorted(v) for k, v in out.items()}


# ------------------------------------------------------- static passes ----

EXPECTED = {
    "ba003_unknown_rule.py": ["BA003"],
    "federation/scheduler.py": ["TH201"],
    "pb101_undeclared_uplink.py": ["PB101"],
    "pb102_grad_downlink.py": ["PB102", "PB102", "PB102"],
    "pb103_raw_features.py": ["PB103"],
    "pb104_unmetered_wire.py": ["PB104"],
    "pb105_raw_losses.py": ["PB105"],
    "suppressed.py": ["BA001", "PB101"],
    "th201_hot_loop.py": ["TH201", "TH201", "TH201"],
    "th202_traced_branch.py": ["TH202"],
    "th203_carry_dtype.py": ["TH203", "TH203"],
    "th204_debug.py": ["TH204", "TH204", "TH204"],
}


def test_every_rule_has_a_failing_fixture(corpus):
    tripped = {f.rule for f in corpus}
    # BA002 needs a broken file (test_ba002_on_unparseable_file); the
    # IF3xx graph rules belong to the certifier, not ported yet
    static_rules = {r for r in cli.RULES if not r.startswith("IF")} - {"BA002"}
    assert static_rules <= tripped, static_rules - tripped


def test_fixture_corpus_exact(corpus):
    assert _rules_by_file(corpus) == EXPECTED


def test_clean_exemplars_stay_quiet(corpus):
    flagged = {os.path.basename(f.path) for f in corpus}
    assert "clean_transport_flow.py" not in flagged
    assert "transportlike.py" not in flagged
    # the quiet twins inside the seeded files (each line marked "quiet")
    flagged_lines = {(os.path.realpath(f.path), f.line) for f in corpus}
    quiet = []
    for root, _, files in os.walk(FIXTURES):
        for name in files:
            path = os.path.realpath(os.path.join(root, name))
            with open(path) as fh:
                quiet += [(path, i) for i, text in enumerate(fh, start=1)
                          if "# quiet" in text]
    assert len(quiet) >= 6
    assert not flagged_lines & set(quiet)


def test_suppression_mechanics(corpus):
    sup = [f for f in corpus if f.path.endswith("suppressed.py")]
    # the justified ignore swallows its PB101; the reasonless one is
    # BA001 and its PB101 survives
    assert {(f.rule, f.line) for f in sup} == {("BA001", 13), ("PB101", 14)}


def test_select_family_filter(corpus, capsys):
    only_pb = cli.select_families(corpus, "PB")
    assert only_pb and {f.rule[:2] for f in only_pb} == {"PB"}
    assert cli.select_families(corpus, "pb, th") == cli.select_families(
        corpus, "PB,TH")
    with pytest.raises(SystemExit) as exc:
        cli.select_families(corpus, "ZZ")
    assert exc.value.code == 2
    with pytest.raises(SystemExit):
        cli.select_families(corpus, "")
    capsys.readouterr()


def test_select_flag_end_to_end(capsys):
    pb_only = os.path.join(FIXTURES, "pb101_undeclared_uplink.py")
    assert cli.main([pb_only, "--strict", "--select", "TH"]) == 0
    assert cli.main([pb_only, "--strict", "--select", "PB"]) == 1
    with pytest.raises(SystemExit) as exc:
        cli.main([pb_only, "--select", "IF,NOPE"])
    assert exc.value.code == 2
    capsys.readouterr()


def test_partial_scan_resolves_registry_accounting(capsys):
    """Scanning ONLY the wire plane still resolves
    ``accounted_by="Transport.account_wire"``: the accounting registry
    (tags.ACCOUNTING_MODULES) seeds the target set on partial scans."""
    assert cli.main([os.path.join(SRC, "wire"), "--strict"]) == 0
    assert "Transport.account_wire" in cli.registry_accounting()
    capsys.readouterr()


def test_ba002_on_unparseable_file(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def oops(:\n")
    findings = cli.analyze_paths([str(bad)])
    assert [f.rule for f in findings] == ["BA002"]


def test_shipped_tree_is_clean():
    assert cli.analyze_paths([SRC]) == []


def test_cli_module_strict_and_certify(capsys, tmp_path):
    """``python -m repro_torch.analysis --strict`` scans the package
    itself (from any directory) and exits 0; ``certify`` on the CPU
    certifies every configuration and writes its certificate."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, os.pardir, "src")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analysis clean" in proc.stderr
    out = tmp_path / "cert.json"
    assert cli.main(["certify", "--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["clean"] is True
    capsys.readouterr()


def test_baseline_workflow(tmp_path, capsys):
    base = str(tmp_path / "baseline.json")
    assert cli.main([FIXTURES, "--write-baseline", base]) == 0
    keys = json.loads(open(base).read())
    assert len(keys) == sum(len(v) for v in EXPECTED.values())
    # baselined findings are tolerated...
    assert cli.main([FIXTURES, "--baseline", base]) == 0
    # ...but --strict ignores the baseline entirely
    assert cli.main([FIXTURES, "--baseline", base, "--strict"]) == 1
    capsys.readouterr()


def test_wire_decorator_stacks_and_host_boundary_needs_reason():
    @tags.wire("up", accounted_by="Transport.account")
    @tags.wire("down", accounted_by="Transport.account", kind="loss")
    def both_ways():
        return None

    assert [w["direction"] for w in both_ways.__vfl_wire__] == ["down", "up"]
    with pytest.raises(ValueError):
        tags.host_boundary("")
    with pytest.raises(ValueError):
        tags.wire("sideways", accounted_by="Transport.account")
    with pytest.raises(ValueError):
        tags.party("referee")


# --------------------------------------------------- runtime sentinels ----


def test_host_sentinel_counts_each_read_once():
    rep = runtime.SanitizerReport()
    with runtime.host_transfer_sentinel(rep):
        x = torch.arange(4) * 2
        np.asarray(x)                       # 1: __array__ (numpy inside)
        y = torch.arange(4) + 1
        y.tolist()                          # 2
        (torch.ones(()) * 3).item()         # 3
        int(torch.arange(5).sum())          # 4
        float(torch.ones(()))               # 5
        bool(torch.ones(()) > 0)            # 6
        [1, 2, 3][torch.tensor(1)]          # 7: __index__
        torch.arange(3).cpu()               # a CPU tensor: nothing moves
        np.asarray(np.arange(4))            # a host array: free
    assert rep.d2h == 7, rep.d2h_sites
    assert all(site.startswith(__file__) for site in rep.d2h_sites)
    # the patches are gone after the region
    assert "item" not in torch.Tensor.__dict__
    assert torch.Tensor.__bool__ is torch._C.TensorBase.__bool__


def test_strict_raises_and_names_the_call_site():
    with pytest.raises(runtime.StrictModeViolation) as exc:
        with runtime.strict():
            np.asarray(torch.arange(3) + 7)
    assert "test_torch_analysis.py" in str(exc.value)
    # nested regions each count the read
    with runtime.strict(check=False) as outer:
        with runtime.strict(max_host_transfers=1) as inner:
            torch.ones(()).item()
    assert outer.d2h == inner.d2h == 1


def test_recompile_sentinel_fresh_vs_cached(tmp_path, monkeypatch):
    """A kernel library built in the region is a fresh compile; the same
    library found built is not (a stand-in ``nvcc`` writes the output
    file: the CPU has no toolkit). A CUDA graph capture counts the same
    way (``test_recompile_sentinel_counts_captures_on_the_card``)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 1 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
                    "  shift\ndone\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    fresh, cached = runtime.SanitizerReport(), runtime.SanitizerReport()
    with runtime.recompile_sentinel(fresh):
        _build.build_all(["rmsnorm"])
    with runtime.recompile_sentinel(cached):
        _build.build_all(["rmsnorm"])
    assert fresh.compiles == 1 and fresh.compiled_names == [
        "nvcc build of rmsnorm"]
    assert cached.compiles == 0
    assert _build.build_all.__module__ == _build.__name__   # unpatched


@pytest.mark.gpu
def test_sentinels_on_the_card():
    """On the card: a CUDA tensor's ``.cpu().numpy()`` is one read, and a
    StepGraph capture is a fresh compile while its replays are not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import graphs
    x = torch.arange(8, device="cuda", dtype=torch.float32)
    with runtime.strict(check=False, sync_debug="error") as rep:
        x.cpu().numpy()
        x.sum().item()
    assert rep.d2h == 2, rep.d2h_sites
    buf = torch.zeros(8, device="cuda")
    with runtime.strict(max_compiles=1) as fresh:
        g = graphs.StepGraph(lambda: buf.add_(x), torch.device("cuda"))
    with runtime.strict(sync_debug="error") as cached:
        g.replay(3)
    assert fresh.compiles == 1 and cached.compiles == 0


# ------------------------------------- steady-state scheduler hygiene ----


def test_steady_state_paged_decode_reads_only_at_retirement():
    """On a warmed scheduler, the block steps between admission and
    retirement read the host zero times and compile nothing (strict()
    raises otherwise); the retirement wave is ONE read, named in
    ``_retire_wave`` and counted by ``host_transfers`` too."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.federation import Federation
    from repro_torch.models import common
    PL, GL, n_req = 8, 16, 3
    cfg = reduced(get_config("phi3-mini-3.8b"), d_model=64, n_heads=2,
                  n_kv_heads=1, d_ff=128, vocab_size=256, remat=False,
                  param_dtype="float32")
    fed = Federation.build(cfg, n_clients=2, seq_len=PL + GL, device="cpu")
    params = fed.params_from_global(common.materialize(
        fed.model.param_specs, torch.Generator().manual_seed(0)))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (n_req, PL), np.int32)
    srv = fed.serve(params, max_batch=n_req)
    for i in range(n_req):
        srv.submit(prompts[i], GL, seed=i)
    warm = srv.run()

    for i in range(n_req):
        srv.submit(prompts[i], GL, seed=i)
    srv._admit_free_slots()

    def occupied():
        return [s for s in range(srv.max_batch)
                if srv._slot_req[s] is not None]

    blocks = 0
    with runtime.strict() as rep:        # raises StrictModeViolation on any
        while occupied() and min(srv._remaining[s]
                                 for s in occupied()) > 0:
            srv._block_step()
            blocks += 1
    assert blocks and rep.d2h == 0 and rep.compiles == 0

    before = srv.host_transfers
    with runtime.strict(max_host_transfers=1) as wave:
        srv._retire_wave()               # the one sanctioned wave fetch
    assert wave.d2h == 1 == srv.host_transfers - before
    (site,) = wave.d2h_sites
    assert "federation/scheduler.py" in site
    res = [srv.results[r.rid + n_req] for r in warm]
    assert all(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(res, warm))
