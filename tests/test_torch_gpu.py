"""The port's CUDA kernels and its GPU path, on a GPU.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither jax nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m cuda -q

Each kernel is held bitwise to its plain PyTorch version on the same
device, and the GPU path of ML-KEM-768 to the CPU path.
"""

import asyncio

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu_torch.core import keccak, keccak_cuda
from quantum_resistant_p2p_tpu_torch.kem import mlkem, mlkem_cuda
from quantum_resistant_p2p_tpu_torch.provider import BatchedKEM, get_kem

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _u8(seed: int, *shape) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, 256, size=shape, dtype=np.uint8))


@pytest.mark.parametrize("rate,ds,length,out_len", [
    (136, 0x06, 1184, 32), (72, 0x06, 64, 64), (136, 0x1F, 1120, 32),
    (168, 0x1F, 34, 672), (136, 0x1F, 0, 300), (72, 0x06, 71, 200)])
def test_sponge_kernel_matches_plain(gpu, rate, ds, length, out_len):
    x = _u8(length, 257, length).to(gpu)
    before = keccak_cuda.sponge.launches
    got = keccak.sponge(x, rate, ds, out_len)
    torch.cuda.synchronize()
    assert keccak_cuda.sponge.launches == before + 1
    assert torch.equal(got, keccak.sponge_plain(x, rate, ds, out_len))


def test_mlkem_kernels_match_plain(gpu):
    seeds = _u8(80, 300, 34).to(gpu)
    assert torch.equal(mlkem_cuda.sample_ntt(seeds), mlkem.sample_ntt_plain(seeds))
    prf = _u8(81, 300, 33).to(gpu)
    for eta in (2, 3):
        assert torch.equal(mlkem_cuda.prf_cbd(prf, eta), mlkem.prf_cbd_plain(prf, eta))
        assert torch.equal(mlkem_cuda.prf_cbd_ntt(prf, eta), mlkem.prf_cbd_ntt_plain(prf, eta))
    f = torch.randint(0, mlkem.Q, (300, 256), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(82)).to(gpu)
    assert torch.equal(mlkem_cuda.ntt(f), mlkem.ntt_plain(f))
    assert torch.equal(mlkem_cuda.ntt_inv(f), mlkem.ntt_inv_plain(f))
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["ML-KEM-512", "ML-KEM-768", "ML-KEM-1024"])
def test_gpu_path_matches_cpu_path(gpu, name):
    p = mlkem.PARAMS[name]
    d, z, m = _u8(90, 16, 32), _u8(91, 16, 32), _u8(92, 16, 32)
    ek, dk = mlkem.keygen(p, d.to(gpu), z.to(gpu))
    key, ct = mlkem.encaps(p, ek, m.to(gpu))
    bad = ct.clone()
    bad[:, 0] ^= 1
    key2, rej = mlkem.decaps(p, dk, ct), mlkem.decaps(p, dk, bad)
    ek_c, dk_c = mlkem.keygen(p, d, z)
    key_c, ct_c = mlkem.encaps(p, ek_c, m)
    for a, b in ((ek, ek_c), (dk, dk_c), (key, key_c), (ct, ct_c), (key2, key_c),
                 (rej, mlkem.decaps(p, dk_c, bad.cpu()))):
        assert torch.equal(a.cpu(), b)


def test_batched_kem_on_the_default_backend(gpu):
    kem = get_kem("ML-KEM-768")
    assert kem.backend == "cuda"

    async def run():
        with BatchedKEM(kem, max_wait_ms=5.0) as bk:
            async def client():
                pk, sk = await bk.generate_keypair()
                ct, ss = await bk.encapsulate(pk)
                return ss == await bk.decapsulate(sk, ct)

            return await asyncio.gather(*(client() for _ in range(64)))

    assert all(asyncio.run(run()))
