"""xLSTM-350M [arXiv:2405.04517] — xLSTM[7:1]: periods of 7 mLSTM blocks +
1 sLSTM block. 24 layers = 3 periods of 8. mLSTM uses the chunkwise-parallel
matrix-memory form; sLSTM is a true time-recurrent cell with exponential
gating and a post-cell FFN (4/3 multiplier, per the paper's sLSTM block).
"""
from repro_torch.configs.base import BlockCfg, LayerGroup, ModelConfig, SSMCfg

SOURCE = "arXiv:2405.04517"


def _cfg(name, n_periods, n_m, d_model, n_heads, vocab, chunk) -> ModelConfig:
    mlstm = BlockCfg(kind="mlstm",
                     ssm=SSMCfg(kind="mlstm", n_heads=n_heads, expand=2,
                                d_conv=4, chunk_size=chunk))
    slstm = BlockCfg(kind="slstm",
                     ssm=SSMCfg(kind="slstm", n_heads=n_heads, expand=1,
                                ff_mult=4.0 / 3.0))
    return ModelConfig(
        name=name, family="ssm", source=SOURCE, d_model=d_model,
        vocab_size=vocab, norm_eps=1e-6,
        groups=(LayerGroup(period=(mlstm,) * n_m + (slstm,),
                           n_periods=n_periods),))


def make_config(tiny: bool = False) -> ModelConfig:
    if tiny:
        return _cfg("xlstm-350m-tiny", 1, 1, 256, 2, 512, 64)
    # 24 layers = 3 x (7 mLSTM + 1 sLSTM)
    return _cfg("xlstm-350m", 3, 7, 1024, 4, 50304, 256)
