"""The paper's own evaluation models, used by the simulator/benchmarks to
reproduce Figure 2/3: GPT-J-6B, Vicuna-13B, Llama3-70B.

GPT-J's parallel-block detail is not modeled (it does not affect the
interception/scheduling experiments, which only need sizes for T_fwd / M);
it is represented as an equivalent-size dense decoder.
"""
from repro_torch.configs.base import ModelConfig, simple_dense


def gptj_6b(tiny: bool = False) -> ModelConfig:
    if tiny:
        return simple_dense("gpt-j-6b-tiny", "hf:EleutherAI/gpt-j-6b",
                            n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                            head_dim=64, d_ff=1024, vocab_size=512,
                            gated=False, activation="gelu")
    return simple_dense("gpt-j-6b", "hf:EleutherAI/gpt-j-6b", n_layers=28,
                        d_model=4096, n_heads=16, n_kv_heads=16, head_dim=256,
                        d_ff=16384, vocab_size=50400, gated=False,
                        activation="gelu")


def vicuna_13b(tiny: bool = False) -> ModelConfig:
    if tiny:
        return simple_dense("vicuna-13b-tiny", "arXiv:2306.05685", n_layers=2,
                            d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                            d_ff=512, vocab_size=512)
    return simple_dense("vicuna-13b", "arXiv:2306.05685", n_layers=40,
                        d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
                        d_ff=13824, vocab_size=32000)


def llama3_70b(tiny: bool = False) -> ModelConfig:
    if tiny:
        return simple_dense("llama3-70b-tiny", "https://llama.meta.com/llama3",
                            n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                            head_dim=32, d_ff=512, vocab_size=512)
    return simple_dense("llama3-70b", "https://llama.meta.com/llama3",
                        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
                        head_dim=128, d_ff=28672, vocab_size=128256,
                        rope_theta=500000.0)
