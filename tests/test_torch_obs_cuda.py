"""PyTorch port: the observability instruments that read the card, on the
card only (marked ``cuda``; each skips here, where there is none). The memory
monitor's allocator statistics, the duty probe's idle baseline and a busy
reading, the peak table's entry for the H100 SXM part, and a profile window
over a GraNd and an EL2N scoring batch whose capture names the direct, Gram
and EL2N kernels. Imports no JAX, so it runs on the card's machine:
``pytest --noconftest -m cuda tests/test_torch_obs_cuda.py``."""

import json
import os

import pytest
import torch

from data_diet_distributed_tpu_torch.models import create_model
from data_diet_distributed_tpu_torch.obs import introspect, profiler
from data_diet_distributed_tpu_torch.obs.monitor import _DutyProbe, sample_devices
from data_diet_distributed_tpu_torch.ops import kernels
from data_diet_distributed_tpu_torch.ops.scores import make_local_scores, resolve_score_method
from data_diet_distributed_tpu_torch.weights import init_variables


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the instruments read its allocator and streams")
    return torch.device("cuda")


@pytest.mark.cuda
def test_memory_monitor_reads_the_allocator(cuda):
    hbm = introspect.HbmMonitor(device=cuda, jump_frac=0.1)
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    got = hbm.poll()
    assert got is not None and got["bytes_in_use"] >= keep.numel()
    assert got["peak_bytes"] >= got["bytes_in_use"] > 0
    dev = sample_devices(cuda)[0]
    assert dev["bytes_limit"] > dev["bytes_in_use"] >= keep.numel()


@pytest.mark.cuda
def test_duty_probe_reads_idle_then_busy(cuda):
    probe = _DutyProbe(cuda)
    idle = probe.sample(0.05, n=4)
    assert idle["probe_base_ms"] > 0 and idle["duty_cycle"] <= 0.5
    a = torch.randn(8192, 8192, device=cuda)
    for _ in range(20):   # seconds of queued work on the default stream
        a = a @ a
        a = a / a.norm()
    busy = probe.stats([probe.probe_ms()])
    assert busy["duty_cycle"] == 1.0


@pytest.mark.cuda
def test_peak_table_names_the_card(cuda):
    peak, source = introspect.device_peak_flops(cuda)
    name = torch.cuda.get_device_name(cuda)
    if name in introspect.PEAK_FLOPS_PER_DEVICE:
        assert (peak, source) == (introspect.PEAK_FLOPS_PER_DEVICE[name], f"table:{name}")
    else:
        assert source == "calibrated" and peak > 1e12


@pytest.mark.cuda
def test_profile_window_names_the_path_kernels(cuda, tmp_path):
    model = create_model("resnet18", 10, half_precision=True).to(
        cuda, memory_format=torch.channels_last).eval()
    variables = init_variables("resnet18", 0, cuda, num_classes=10)
    gen = torch.Generator(device=cuda).manual_seed(0)
    image = torch.randn((64, 32, 32, 3), generator=gen, device=cuda)
    label = torch.randint(0, 10, (64,), generator=gen, device=cuda)
    mask = torch.ones(64, device=cuda)
    fns = [make_local_scores(model, resolve_score_method(m, True), use_kernels=True)
           for m in ("grand", "el2n")]
    before = kernels.launch_counts()
    profiler.ProfileWindow.reset()
    window = profiler.ProfileWindow(str(tmp_path), "score", start_epoch=0, num_epochs=1,
                                    window_chunks=4, device_type="cuda")
    for _ in range(3):
        window.tick(0)
        for fn in fns:
            fn(variables, image, label, mask)
    window.close()
    assert window.path == os.path.join(str(tmp_path), "score", "trace.json")
    with open(window.path) as fh:
        names = [e.get("name", "") for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "kernel"]
    for fn in ("direct_mma_kernel", "gram_kernel", "el2n_kernel"):
        assert any(fn in n for n in names), fn
    after = kernels.launch_counts()
    assert all(after[k] > before[k] for k in
               ("conv_grad_norm_direct", "conv_grad_norm_gram", "el2n"))
