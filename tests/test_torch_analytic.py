"""The launch modules copied from the reference (``launch/analytic.py``,
``launch/roofline.py``, ``launch/report.py``) on the port.

* ``step_cost(cfg, shape).flops_global`` against the floating-point
  operations ``torch.utils.flop_counter.FlopCounterMode`` counts over the
  port's prefill (``launch/steps.py``) and train step, on the reference
  test's one-layer probe and on tiny llama3.2-1b, within the bands of
  ``tests/test_analytic.py`` (the analytic prefill takes an average
  context of S/2 under the causal mask; its train step prices remat, which
  these steps run without).
* ``collective_bytes_from_hlo`` on that test's HLO text; the kv-dtype
  repricing of Eq. 5's terms on the port's H100 spec; ``analyze`` on the
  H100 spec and ``report.table`` formatting its row.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, simple_dense
from repro_torch.core.costmodel import CostModel
from repro_torch.launch import report
from repro_torch.launch.analytic import step_cost
from repro_torch.launch.roofline import analyze, collective_bytes_from_hlo
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.training.optimizer import adamw_init
from repro_torch.utils.hw import H100, dtype_bytes

B, S = 2, 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs under xdist on a few cores; torch's intra-op threads
    would oversubscribe them, so each worker's torch runs one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probe():
    return simple_dense("probe", "test", n_layers=1, d_model=256, n_heads=8,
                        n_kv_heads=8, head_dim=32, d_ff=1024,
                        vocab_size=1024, dtype="float32")


CFGS = {"probe": _probe,
        "llama3.2-1b-tiny": lambda: get_config("llama3.2-1b", tiny=True)}


def _counted(fn, *args) -> float:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return float(fc.get_total_flops())


def _params(model):
    gen = torch.Generator().manual_seed(0)
    return model.init(gen, dtype=torch.float32, device="cpu")


def _tokens(cfg):
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=gen)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_flops_match(name):
    cfg = CFGS[name]()
    model, fn = build_prefill_step(cfg, S)
    got = _counted(fn, _params(model), _tokens(cfg))
    want = step_cost(cfg, InputShape("probe", S, B, "prefill")).flops_global
    assert want * 0.4 < got < want * 2.5, (got, want)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_flops_match(name):
    cfg = CFGS[name]()
    model, fn = build_train_step(cfg, remat=False)
    params = _params(model)
    toks = _tokens(cfg)
    got = _counted(fn, params, adamw_init(params), toks, toks,
                   torch.ones(B, S))
    want = step_cost(cfg, InputShape("probe", S, B, "train")).flops_global
    # the analytic count adds remat's forward (4x forward); these steps
    # run 3x: expect got ~ 0.75 want
    assert want * 0.3 < got < want * 1.8, (got, want)


HLO = """
%wbody.1 (p: f32[8]) -> f32[8] {
  %ar.5 = f32[8]{0} all-reduce(f32[8]{0} %p), to_apply=%sum
}
ENTRY %main (x: f32[8]) -> f32[8] {
  %w = f32[8]{0} while(f32[8]{0} %x), condition=%c, body=%wbody.1
  %ag = f32[16]{0} all-gather(f32[8]{0} %w)
}
"""


def test_collective_parser_loop_multiplier():
    got = collective_bytes_from_hlo(HLO, loop_multiplier=10)
    assert got["all-reduce"] == 8 * 4 * 10
    assert got["all-gather"] == 16 * 4


def test_dtype_bytes_covers_quantized_kv_dtypes():
    assert dtype_bytes("int8") == 1
    assert dtype_bytes("float8_e4m3") == 1
    assert dtype_bytes("float8_e5m2") == 1
    assert dtype_bytes("bfloat16") == 2
    assert dtype_bytes("float32") == 4


def test_costmodel_kv_dtype_reprices_eq5_terms_on_h100():
    """On the H100 spec as on the reference's A100: M follows the KV
    storage dtype while weight bytes, FLOPs and S stay put."""
    cfg = get_config("gpt-j-6b")
    base = CostModel(cfg=cfg, chip=H100, n_chips=1)
    for name in ("int8", "float8_e4m3", "float8_e5m2"):
        q = CostModel(cfg=cfg, chip=H100, n_chips=1, kv_dtype=name)
        assert q.m_bytes * 2 == base.m_bytes
        assert q.weight_bytes == base.weight_bytes
        assert q.saturation_tokens == base.saturation_tokens
        assert q.t_swap(4096) * 2 == pytest.approx(base.t_swap(4096))
        assert abs(q.swap_tokens_within(0.02)
                   - 2 * base.swap_tokens_within(0.02)) <= 1
        assert q.kv_capacity_tokens() >= 2 * base.kv_capacity_tokens()
    assert CostModel(cfg=cfg, chip=H100, n_chips=1,
                     kv_dtype=None).m_bytes == base.m_bytes


class _Compiled:
    """What ``analyze`` reads of a compiled step: a cost analysis and the
    HLO text."""

    def cost_analysis(self):
        return [{"flops": 1.5e12, "bytes accessed": 2.5e9}]

    def as_text(self):
        return HLO


def test_roofline_on_h100_and_report_table():
    cfg = get_config("llama3.2-1b")
    shape = InputShape("prefill_32k", 32768, 8, "prefill")
    rep = analyze("llama3.2-1b", "prefill_32k", "single",
                  compiled=_Compiled(), cfg=cfg, shape=shape, chip=H100,
                  n_chips=1, tokens_processed=8 * 32768)
    cost = step_cost(cfg, shape, n_chips=1, model_shards=16,
                     data_shards=16, fsdp=True, batch_shards=1)
    assert rep.compute_term_s == cost.flops_global / H100.peak_flops_bf16
    assert rep.memory_term_s == \
        cost.hbm_bytes_per_chip / H100.hbm_bandwidth
    # the HLO's collectives, an all-reduce counted twice, over NVLink
    mult = rep.scan_multiplier
    assert rep.collective_bytes_per_chip == 2 * 32 * mult + 64
    assert rep.collective_term_s == \
        rep.collective_bytes_per_chip / H100.ici_link_bandwidth
    assert rep.dominant == "compute"
    row = {**rep.to_dict(), "compiled": True}
    text = report.table([row, {**row, "mesh": "4x4"}])
    lines = text.splitlines()
    assert lines[0].startswith("| arch | shape | compute |")
    assert len(lines) == 3                       # header, rule, one row
    assert lines[2].startswith("| llama3.2-1b | prefill_32k | ")
    assert f"**{rep.dominant}**" in lines[2]
    assert report.fmt_s(rep.compute_term_s) in lines[2]
    assert report.fmt_s(2.0) == "2.00s" and report.fmt_s(2e-3) == "2.00ms"
    assert report.fmt_s(2e-6) == "2.0us"
    assert report.interesting([row])[0][1:] == \
        ("compute", "llama3.2-1b", "prefill_32k")
