"""Model zoo of the port. MMOECut, the flagship, is ported; the other
names of the JAX package's zoo are known here and raise until their slice
lands (ROADMAP.md)."""

from rlt_tpu_torch.models.layers import (  # noqa: F401
    LSTM,
    LayerNorm,
    SelfAttention,
    TorchLinear,
    TowerClass,
    TowerCut,
    TowerRerank,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from rlt_tpu_torch.models.mmoe import ExpertStack, MMOECut, make_towers  # noqa: F401

MODELS = {"mmoecut": MMOECut}

# every model name of the JAX package's zoo, ported or not
MODEL_NAMES = frozenset({"bicut", "choopy", "attncut", "mtchoopy", "mtattncut",
                         "mmoecut", "moecut", "mtple", "probe_base"})

# Models whose forward returns a list of task heads, decoded from the LAST
# head (the cut tower); the reference keys this on `"m" in model_name`.
MULTI_HEAD = frozenset({"mtchoopy", "mtattncut", "mmoecut", "moecut", "mtple"})


def is_multi_head(name: str) -> bool:
    """True when `name`'s forward output is a list of heads."""
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model: {name!r}")
    return name in MULTI_HEAD


def build_model(name: str, *, seq_len: int, input_size: int, dropout: float,
                num_tasks: float = 3, seed: int = 0):
    """Model dispatch mirroring the JAX package's `build_model`, with the
    initial weights drawn from `seed`."""
    if name in MODELS:
        return MODELS[name](seq_len=seq_len, num_tasks=num_tasks,
                            input_size=input_size, dropout=dropout, seed=seed)
    if name in MODEL_NAMES:
        raise NotImplementedError(
            f"model {name!r} is not ported to rlt_tpu_torch yet; see ROADMAP.md "
            "for the order in which the zoo is ported")
    raise ValueError(f"unknown model: {name!r}")
