"""The port's boundary certifier (``repro_torch.analysis.certify``) against
the JAX package's committed certificate, ``CERT_boundary.json``.

``repro``'s certifier no longer runs under this jax (its pass reads
``jax.core`` names jax 0.9 dropped), so the committed certificate is the
oracle for the whole inventory: for each of its 11 configurations the
port's certificate on the CPU has the same status, findings, crossings
(kind, direction, shape, dtype, elements, taint), ``n_dp_eqns`` and
``out_taints``. The serve plane's decode body runs ``gen_len`` times in
the port's trace (a Python loop of the body, where ``repro`` traced one
``lax.scan`` body), so each of its decode steps is held to the JSON's one
step. The cascaded-sharded entry's collective bytes differ by design
(the port gathers no client ids and all-reduces only the client leaves)
and are not compared; its kinds and counts are checked against the
step's derivation. Also: the negative controls trip IF301, ``main``
writes its certificate and exits 0, and IF304 catches a forced
disagreement between the inventory and the wire ledger, as ``repro``'s
IF304 check does on the same inventories.
"""
import json
import os

import pytest

from repro.analysis import certify as jcertify
from repro.analysis import ifc as jifc
from repro_torch.analysis import certify, ifc

CERT = os.path.join(os.path.dirname(__file__), os.pardir,
                    "CERT_boundary.json")
with open(CERT) as _fh:
    REFERENCE = json.load(_fh)
METHODS = sorted(REFERENCE["methods"])
SERVER = frozenset({ifc.SERVER})
CLEAN = frozenset()


@pytest.fixture(scope="module")
def certificate():
    findings, cert = certify.build_certificate("cpu")
    return findings, cert


def test_certificate_covers_the_reference_configurations(certificate):
    findings, cert = certificate
    assert findings == []
    assert cert["clean"] is True
    assert sorted(cert["methods"]) == METHODS
    assert cert["rules"] == REFERENCE["rules"]
    assert cert["wire"] == REFERENCE["wire"]


@pytest.mark.parametrize("name", METHODS)
def test_configuration_matches_the_reference(certificate, name):
    _, cert = certificate
    got, want = cert["methods"][name], REFERENCE["methods"][name]
    for key in ("status", "findings", "expected_failure", "tripped"):
        assert got.get(key) == want.get(key), key
    assert got["meta"] == want["meta"]
    g, w = got["report"], want["report"]
    assert g["n_dp_eqns"] == w["n_dp_eqns"]
    assert g["out_taints"] == w["out_taints"]
    if name == "split-serve":
        steps = got["per_step"]
        assert len(steps) == want["meta"]["gen_len"] == 4
        for step in steps:
            assert step == w["crossings"]
        assert g["crossings"] == [c for s in steps for c in s]
    else:
        assert g["crossings"] == w["crossings"]


def test_negative_controls_trip_if301(certificate):
    _, cert = certificate
    for name in ("vafl", "split"):
        entry = cert["methods"][name]
        assert entry["status"] == "declared-leaky"
        assert entry["tripped"] is True
        assert "IF301" in entry["findings"]


def test_sharded_collectives_follow_the_derivation(certificate):
    _, cert = certificate
    coll = cert["methods"]["cascaded-sharded"]["collectives"]
    # two all-gathers at the server-loss boundary, one all-reduce a client
    # leaf (w, b), no other kind
    assert coll["count"] == {"all-gather": 2, "all-reduce": 2}
    assert set(coll) == {"all-gather", "all-reduce", "total", "count"}


def test_certify_main_writes_certificate(tmp_path, capsys, certificate,
                                         monkeypatch):
    out = tmp_path / "cert.json"
    monkeypatch.setattr(certify, "build_certificate",
                        lambda device=None: certificate)
    assert certify.main(["--strict", "--device", "cpu", "--out",
                         str(out)]) == 0
    cert = json.loads(out.read_text())
    assert sorted(cert["rules"]) == ["IF301", "IF302", "IF303", "IF304"]
    assert cert["clean"] is True
    assert "9 configuration(s) certified, 2 negative control(s)" in \
        capsys.readouterr().out


def test_default_out_is_under_build():
    assert certify.DEFAULT_OUT.split(os.sep)[0] == "build"


def test_if304_catches_wire_disagreement():
    """Force a disagreement: an inventory whose downlink carries more
    scalars than the ledger formula bills must be IF304, and an
    unserializable payload kind is IF304 regardless of counts — the
    rules ``repro``'s IF304 check gives on the same inventories."""
    meta = {"method": "cascaded", "zoo_queries": 2, "batch": 4}
    cases = [
        [("loss", "down", (7,), "float32", SERVER),
         ("emb", "up", (3, 4, 4), "float32", CLEAN)],
        [("token", "down", (3,), "int32", SERVER)],
    ]
    for i, crossings in enumerate(cases):
        rep = ifc.IFCReport(out_taints=[CLEAN], n_dp_eqns=0,
                            crossings=[ifc.Crossing(*c) for c in crossings])
        jrep = jifc.IFCReport(out_taints=[CLEAN], n_dp_eqns=0,
                              crossings=[jifc.Crossing(*c)
                                         for c in crossings])
        got = [f.rule for f in certify.train_if304(
            f"forced{i}", rep, meta, embed=4, rounds_per_trace=1)]
        want = [f.rule for f in jcertify._train_if304(
            f"forced{i}", jrep, meta, rounds_per_trace=1)]
        assert got == want
        assert set(got) == {"IF304"}


def test_serve_if304_holds_each_decode_step():
    """A decode step that downlinks its logits in place of the token ids,
    or lacks its uplink, is IF304."""
    tok = ifc.Crossing("token", "down", (2,), "int32", SERVER)
    emb = ifc.Crossing("emb", "up", (2, 1, 32), "bfloat16", CLEAN)
    logits = ifc.Crossing("token", "down", (2,), "float32", SERVER)
    assert certify.serve_if304("ok", [[tok, emb]] * 4, batch=2,
                               d_model=32) == []
    rules = [f.rule for f in certify.serve_if304(
        "bad", [[tok, emb], [logits, emb], [tok]], batch=2, d_model=32)]
    assert rules == ["IF304", "IF304"]
