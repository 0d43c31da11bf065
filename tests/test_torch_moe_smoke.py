"""chip_smoke.py's MoE phases rehearsed at the tiny deepseek-moe-16b on
the CPU, through the plain versions: ``moe_serve`` with the recorder of
the timing phase's rows 9 and 9d, and ``moe_parity``'s fused, per-call
and gather legs (float32; logits 1e-4, pools and cache 1e-4 of their
largest entry, greedy ids equal, layer 0's K/V within 1e-5 of the float64
witness, as ``tests/wide_models.py`` holds the other parity rehearsals).
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    yield chip_smoke
    torch.set_num_threads(n)


def test_moe_serve_rehearsal(cs):
    """moe_serve through the checks and launch-count reads of the card, no
    launch here; the recorded calls and their bound's inputs."""
    rec = cs.MoERecorder()
    policy, kw = cs.MOE_SERVE_PHASES["moe_serve"]
    with rec:
        res = cs.serve(policy, tiny=True, device="cpu", model=cs.MOE_MODEL,
                       **kw)
    assert res["finished"] == res["requests"]
    assert res["model"] == "deepseek-moe-16b-tiny"
    assert all(v == 0 for v in res["launches"].values())
    assert rec.decode_launches > 0 and set(rec.calls) == set(cs.MOE_KERNELS)
    args, _ = rec.call("moe_experts", device="cpu")
    nbytes, ops, touched, kept = cs.moe_work(args)
    assert kept == args[5].numel() and 0 < touched <= 4
    assert ops == 2 * kept * 256 * 128 * 3
    assert nbytes >= touched * 3 * 256 * 128 * 4


def test_moe_parity_rehearsal(cs):
    """The tiny config cut to a dense layer and two MoE layers, the
    prefill legs at capacity factor E / k."""
    f = cs.moe_ffn(tiny=True)
    r = cs.paths_parity(torch.float32, conditioned=True, tiny=True,
                        device="cpu", model=cs.MOE_MODEL, periods=(1, 2),
                        prefill_cf=f.n_routed_experts / f.top_k,
                        lens=[37, 90, 16])
    assert r["model"] == "deepseek-moe-16b-tiny-periods1x2"
    for leg in ("prefill", "decode", "gather"):
        assert r[f"{leg}_err"] <= 1e-4, leg
        assert r[f"{leg}_ids"][0] == r[f"{leg}_ids"][1], leg
    (pe, pt), (de, dt) = r["prefill_pools"], r["decode_pools"]
    assert pe <= 1e-4 * pt and de <= 1e-4 * dt
    assert r["gather_cache"][0] <= 1e-4 * r["gather_cache"][1]
    wf, wu, wt = r["layer0_witness"]
    assert max(wf, wu) <= 1e-5 * wt
