"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes. Every test here needs a CUDA device and skips
without one; the file imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Integer outputs must be equal; fused-query values within atol 1e-4,
rtol 1e-5 (f32 dots summed in another order), positions tie-aware.
``chip_smoke.py`` repeats the comparison at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_topk_tie_aware, make_runs
from repro_torch.core.engine import quantize_payload
from repro_torch.kernels import ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [27, 48, 64])
def test_hash_encode_and_hamming_kernels_equal_plain(cuda_device, L):
    rng = np.random.default_rng(50 + L)
    x = torch.as_tensor(rng.standard_normal((1000, 33)).astype(np.float32),
                        device=cuda_device)
    A = torch.as_tensor(rng.standard_normal((33, L)).astype(np.float32),
                        device=cuda_device)
    tail = torch.as_tensor(rng.random(1000).astype(np.float32),
                           device=cuda_device)
    a_tail = torch.as_tensor(rng.standard_normal(L).astype(np.float32),
                             device=cuda_device)
    codes = ops.hash_encode(x, A, tail, a_tail, impl="cuda")
    assert torch.equal(codes, ops.hash_encode(x, A, tail, a_tail,
                                              impl="ref"))
    assert not ((codes[:, -1].long() & 0xFFFFFFFF) >> (L % 32 or 32)).any()
    assert torch.equal(ops.hamming_scan(codes[:70], codes, impl="cuda"),
                       ops.hamming_scan(codes[:70], codes, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_gather_and_fused_kernels_equal_plain(cuda_device, quantized):
    rng = np.random.default_rng(60)
    n, d, q, k = 4000, 32, 16, 10
    items = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32),
                            device=cuda_device)
    queries = torch.as_tensor(rng.standard_normal((q, d)).astype(np.float32),
                              device=cuda_device)
    cum, starts, total = make_runs(rng, q, 300, n)
    cum = torch.as_tensor(cum, device=cuda_device)
    starts = torch.as_tensor(starts, device=cuda_device)
    assert torch.equal(ops.bucket_gather(cum, starts, total, impl="cuda"),
                       ops.bucket_gather(cum, starts, total, impl="ref"))
    kw = {}
    if quantized:
        payload, scale = quantize_payload(items)
        kw = {"payload": payload, "scale": scale}
    gv, gp = ops.fused_query(queries, cum, starts, items, total, k,
                             impl="cuda", **kw)
    wv, wp = ops.fused_query(queries, cum, starts, items, total, k,
                             impl="ref", **kw)
    assert_topk_tie_aware(gp.cpu().numpy(), gv.cpu().numpy(),
                          wp.cpu().numpy(), wv.cpu().numpy())


@pytest.mark.cuda
def test_auto_on_cuda_launches_the_kernels(cuda_device):
    ops.reset_launch_counts()
    x = torch.randn((64, 16), device=cuda_device)
    A = torch.randn((16, 27), device=cuda_device)
    codes = ops.hash_encode(x, A)
    ops.hamming_scan(codes[:8], codes)
    cum = torch.tensor([[0, 3, 5]], dtype=torch.int32, device=cuda_device)
    starts = torch.tensor([[4, 10]], dtype=torch.int32, device=cuda_device)
    ops.bucket_gather(cum, starts, 5)
    ops.fused_query(x[:1], cum, starts, x, 5, 2)
    payload, scale = quantize_payload(x)
    ops.fused_query(x[:1], cum, starts, x, 5, 2, payload=payload, scale=scale)
    torch.cuda.synchronize()
    assert ops.launch_counts == {name: 1 for name in ops.KERNELS}
