# The distributed layer of flow_tpu_torch (parallel/) on the cards against
# gloo CPU ranks: the four distributed steppers on the small float64
# problems of parallel/cases.parity_cases (the packed stepper on Kármán
# lcar=0.2, ShardedProjection and HaloPoisson on the lid square,
# HaloProjection with the multigrid and BDF2, and its window route, K3 on
# the card, lagged and Newton), one rank on NCCL against one gloo rank, and
# where two or four cards are present, 2 and 4 NCCL ranks against as many
# gloo ranks. Equal counts, state within 1e-8 (the window route computes in
# float32 inside: U within 2e-6 of max|U|, P within 1e-4 of max|P|).
# Skips without a CUDA device. Imports no JAX, so it runs on the machine
# with the card:
#   python -m pytest --noconftest -q tests/test_torch_parallel_cuda.py
import numpy as np
import pytest
import torch

from flow_tpu_torch.parallel import cases, comm

torch.set_num_threads(1)

RUN = "flow_tpu_torch.parallel.cases:run_cases"


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2, 4])
def test_cards_match_cpu_ranks(world):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL ranks on the cards)")
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards")
    pc = cases.parity_cases()
    card = comm.launch(RUN, world, args=(pc, "cuda"), backend="nccl")[0]
    cpu = comm.launch(RUN, world, args=(pc, "cpu"), backend="gloo")[0]
    for (i, same, du, dp, umax), case in zip(cases.compare(card, cpu), pc):
        assert same, (i, case)
        if case.get("kw", {}).get("winkernel"):
            pmax = np.abs(cpu[i]["steps"][-1][1]).max()
            assert du <= 2e-6 * umax and dp <= 1e-4 * pmax, (i, du, dp)
        else:
            assert du <= 1e-8 and dp <= 1e-8, (i, du, dp)
