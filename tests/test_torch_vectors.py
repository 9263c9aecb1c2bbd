"""The three vector fixtures no other port test reads, through the port on
the CPU.

* ``acvp_mlkem768_fixture.json``: its keyGen, encapsulation and
  decapsulation cases through ``kem.mlkem`` (the shape
  ``tests/test_kat.py::test_acvp_dropin_mlkem`` walks).
* ``PQCgenKAT_mlkem512_fixture.rsp`` and
  ``PQCgenKAT_frodo640shake_fixture.rsp``: every stanza's seeds rebuilt
  with the JAX package's CTR-DRBG in the order the reference's
  ``tools/verify_vectors.py`` draws them (ML-KEM: d, z, then m; FrodoKEM:
  s || seedSE || z in one draw, then mu), and keygen, encaps and decaps run
  through the port in one batch.

Tolerance: exact.  PyTorch runs on one thread; JAX's caches are cleared at
the module's end if JAX was loaded (ROADMAP C1).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

from quantum_resistant_p2p_tpu_torch.kem import frodo, frodo_params, mlkem
from quantum_resistant_p2p_tpu_torch.kem import params as mlkem_params

VECTOR_DIR = Path(__file__).parent / "vectors"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch CPU thread; JAX's caches cleared at the end if anything
    loaded JAX (ROADMAP C1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()


def _rows(values) -> torch.Tensor:
    return torch.tensor([list(v) for v in values], dtype=torch.uint8)


def _hex(t: torch.Tensor) -> str:
    return bytes(t.numpy()).hex()


def _acvp_cases(data: dict):
    for group in data.get("testGroups", []):
        meta = {k: v for k, v in group.items() if k != "tests"}
        for case in group.get("tests", []):
            yield {**meta, **case}


def _rsp_stanzas(text: str):
    rec: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            if rec:
                yield rec
                rec = {}
            continue
        key, _, value = line.partition("=")
        rec[key.strip()] = value.strip()
    if rec:
        yield rec


def test_acvp_mlkem768_fixture_through_the_port():
    """Every case of the ACVP-shaped ML-KEM-768 fixture: keyGen from d and
    z, encapsulation from ek and m, decapsulation from dk and c."""
    data = json.loads((VECTOR_DIR / "acvp_mlkem768_fixture.json").read_text())
    p = mlkem_params.PARAMS[data["algorithm"]]
    seen = set()
    for case in _acvp_cases(data):
        if "d" in case and "z" in case:
            ek, dk = mlkem.keygen(p, _rows([bytes.fromhex(case["d"])]),
                                  _rows([bytes.fromhex(case["z"])]))
            assert (_hex(ek[0]), _hex(dk[0])) == (case["ek"].lower(), case["dk"].lower())
            seen.add("keyGen")
        if "m" in case and "ek" in case:
            k, c = mlkem.encaps(p, _rows([bytes.fromhex(case["ek"])]),
                                _rows([bytes.fromhex(case["m"])]))
            assert (_hex(c[0]), _hex(k[0])) == (case["c"].lower(), case["k"].lower())
            seen.add("encapsulation")
        if "dk" in case and "c" in case:
            k = mlkem.decaps(p, _rows([bytes.fromhex(case["dk"])]),
                             _rows([bytes.fromhex(case["c"])]))
            assert _hex(k[0]) == case["k"].lower()
            seen.add("decapsulation")
    assert seen == {"keyGen", "encapsulation", "decapsulation"}


def _drbg_draws(name: str, sizes) -> tuple[list[dict], list[list[bytes]]]:
    """The stanzas of a PQCgenKAT fixture and, for each, the DRBG draws of
    ``sizes`` from its seed."""
    pytest.importorskip("cryptography")  # the DRBG is AES-256-CTR
    from quantum_resistant_p2p_tpu.utils.ctr_drbg import CtrDrbg

    recs = list(_rsp_stanzas((VECTOR_DIR / name).read_text()))
    assert [int(r["count"]) for r in recs] == list(range(len(recs))) and recs
    draws = []
    for rec in recs:
        drbg = CtrDrbg(bytes.fromhex(rec["seed"]))
        draws.append([drbg.random_bytes(n) for n in sizes])
    return recs, draws


def _check(recs, outputs: dict) -> None:
    for i, rec in enumerate(recs):
        for key, t in outputs.items():
            assert _hex(t[i]).upper() == rec[key.split("/")[0]].upper(), (i, key)


def test_pqcgenkat_mlkem512_fixture_through_the_port():
    """Every stanza of PQCgenKAT_mlkem512_fixture.rsp: d, z and m from the
    DRBG; pk, sk, ct and ss from the port, and decaps gives ss back."""
    p = mlkem_params.PARAMS["ML-KEM-512"]
    recs, draws = _drbg_draws("PQCgenKAT_mlkem512_fixture.rsp", (32, 32, 32))

    def col(j):
        return _rows(d[j] for d in draws)

    ek, dk = mlkem.keygen(p, col(0), col(1))
    ss, ct = mlkem.encaps(p, ek, col(2))
    _check(recs, {"pk": ek, "sk": dk, "ct": ct, "ss": ss,
                  "ss/decaps": mlkem.decaps(p, dk, ct)})


def test_pqcgenkat_frodo640shake_fixture_through_the_port():
    """Every stanza of PQCgenKAT_frodo640shake_fixture.rsp: s || seedSE || z
    in one DRBG draw, then mu; pk, sk, ct and ss from the port, and decaps
    gives ss back."""
    p = frodo_params.PARAMS["FrodoKEM-640-SHAKE"]
    recs, draws = _drbg_draws("PQCgenKAT_frodo640shake_fixture.rsp",
                              (2 * p.len_sec + 16, p.len_sec))
    r = _rows(d[0] for d in draws)
    s, seed_se, z = r[:, : p.len_sec], r[:, p.len_sec: 2 * p.len_sec], r[:, 2 * p.len_sec:]
    pk, sk = frodo.keygen(p, s, seed_se, z)
    ct, ss = frodo.encaps(p, pk, _rows(d[1] for d in draws))
    _check(recs, {"pk": pk, "sk": sk, "ct": ct, "ss": ss, "ss/decaps": frodo.decaps(p, sk, ct)})
