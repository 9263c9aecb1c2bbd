"""The port's ``config.py`` against the JAX package's: the 4 tests of
``tests/test_config.py`` (precedence kwargs > env > file > defaults) on the
keys the port keeps, the same file, the JAX package's other keys warned
about and not obeyed, every key reaching the CLI, and the port's backend
values: "cuda" by default, "cpu" when asked for, anything else refused
wherever it comes from.

Tolerance: exact.  Stdlib only; no JAX program.
"""

from __future__ import annotations

import dataclasses
import json
import logging

import pytest

from quantum_resistant_p2p_tpu.config import Config as RefConfig
from quantum_resistant_p2p_tpu_torch import cli
from quantum_resistant_p2p_tpu_torch.config import BACKENDS, UNREAD_KEYS, Config


def test_defaults():
    c = Config.load(path="/nonexistent/config.json")
    assert c.mesh_devices == 0 and c.backend == "cuda" and c.port == 8000


def test_file_env_override(tmp_path, monkeypatch):
    p = tmp_path / "config.json"
    p.write_text(json.dumps({"mesh_devices": 2, "port": 9000, "unknown_key": 1}))
    monkeypatch.setenv("QRP2P_PORT", "9100")
    monkeypatch.setenv("QRP2P_USE_BATCHING", "true")
    c = Config.load(path=p, port=9200)
    assert c.mesh_devices == 2  # file
    assert c.use_batching is True  # env bool
    assert c.port == 9200  # kwarg beats env beats file


def test_malformed_file_falls_back(tmp_path):
    p = tmp_path / "config.json"
    p.write_text("{not json")
    c = Config.load(path=p)
    assert c.port == 8000


def test_save_roundtrip(tmp_path):
    c = Config.load(path="/nonexistent")
    c.port = 9300
    out = c.save(tmp_path / "cfg.json")
    c2 = Config.load(path=out)
    assert c2.port == 9300


def test_keys_and_file_of_the_jax_package(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("QRP2P_TPU_HOME", str(tmp_path))
    ref_keys = [f.name for f in dataclasses.fields(RefConfig)]
    assert [f.name for f in dataclasses.fields(Config)] == \
        [k for k in ref_keys if k not in UNREAD_KEYS]
    assert set(UNREAD_KEYS) < set(ref_keys)
    assert Config.default_path() == RefConfig.default_path() == tmp_path / "config.json"
    # a file the JAX package saved (its backend set to one the port runs)
    ref = RefConfig.load(path="/nonexistent", backend="cpu", port=9400, mesh_devices=2,
                         kem="HQC-192", max_wait_ms=3.5)
    ref.save()
    with caplog.at_level(logging.WARNING, logger="quantum_resistant_p2p_tpu_torch.config"):
        c = Config.load()
    assert dataclasses.asdict(c) == {k: v for k, v in dataclasses.asdict(ref).items()
                                     if k not in UNREAD_KEYS}
    warned = " ".join(r.getMessage() for r in caplog.records)
    assert all(repr(k) in warned for k in UNREAD_KEYS)


@pytest.mark.parametrize("key", UNREAD_KEYS)
def test_unread_keys_warn_and_change_nothing(tmp_path, monkeypatch, caplog, key):
    monkeypatch.setenv(f"QRP2P_{key.upper()}", "1")
    with caplog.at_level(logging.WARNING, logger="quantum_resistant_p2p_tpu_torch.config"):
        c = Config.load(path="/nonexistent")
    assert dataclasses.asdict(c) == dataclasses.asdict(Config())
    assert f"QRP2P_{key.upper()} is not read" in caplog.text
    with pytest.raises(TypeError, match=key):
        Config.load(path="/nonexistent", **{key: 1})


def test_every_key_reaches_the_cli(tmp_path, monkeypatch):
    """``main`` hands each Config key to ``CLI``: none is loaded and dropped."""
    monkeypatch.setenv("QRP2P_TPU_HOME", str(tmp_path))
    p = tmp_path / "config.json"
    p.write_text(json.dumps({"backend": "cpu", "use_batching": True, "port": 9500,
                             "mesh_devices": 3}))
    seen = {}

    class FakeCLI:
        def __init__(self, **kw):
            seen.update(kw)

        def login_interactive(self):
            return False

    monkeypatch.setattr(cli, "CLI", FakeCLI)
    assert cli.main(["--config", str(p), "--no-discovery"]) == 1
    for f in dataclasses.fields(Config):
        assert seen[f.name] == json.loads(p.read_text())[f.name], f.name


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_values_from_each_source(tmp_path, monkeypatch, backend):
    assert BACKENDS == ("cuda", "cpu")
    p = tmp_path / "config.json"
    p.write_text(json.dumps({"backend": backend}))
    assert Config.load(path=p).backend == backend
    monkeypatch.setenv("QRP2P_BACKEND", backend)
    assert Config.load(path="/nonexistent").backend == backend
    assert Config.load(path=p, backend=backend).backend == backend


@pytest.mark.parametrize("source", ["file", "env", "kwarg"])
@pytest.mark.parametrize("backend", ["tpu", "auto"])
def test_other_backends_are_refused(tmp_path, monkeypatch, source, backend):
    p = tmp_path / "config.json"
    kw = {}
    if source == "file":
        p.write_text(json.dumps({"backend": backend}))
    elif source == "env":
        monkeypatch.setenv("QRP2P_BACKEND", backend)
    else:
        kw["backend"] = backend
    with pytest.raises(ValueError, match="cuda, cpu"):
        Config.load(path=p, **kw)
