"""Model zoo of the port: MMOECut (the flagship), MOECut, PLECut, Choopy,
MtChoopy, AttnCut, MtAttnCut and BiCut, which the Trainer trains, and the
probing modules of the verification harnesses: ProbeBase (`probe_base`, a
2-expert MMOECut that also returns its intermediates; it trains through
`rlt_tpu_torch.verify_probe`), Probe, TaskC and TaskR.
`build_population_model` stacks K seeded models of any of the eight into
one model with a member axis (population training)."""

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
from rlt_tpu_torch.models.mmoe import (  # noqa: F401
    ExpertStack,
    MMOECut,
    MOECut,
    PLECut,
    make_towers,
)
from rlt_tpu_torch.models.multitask import MtAttnCut, MtChoopy  # noqa: F401
from rlt_tpu_torch.models.probe import Probe, ProbeBase, TaskC, TaskR  # noqa: F401
from rlt_tpu_torch.models.simple import AttnCut, BiCut, Choopy  # noqa: F401
from rlt_tpu_torch.utils.convert import stack_state_dicts

MODELS = {"bicut": BiCut, "choopy": Choopy, "attncut": AttnCut,
          "mtchoopy": MtChoopy, "mtattncut": MtAttnCut, "mmoecut": MMOECut,
          "moecut": MOECut, "mtple": PLECut}

# every model name of the JAX package's zoo: the eight above and probe_base
MODEL_NAMES = frozenset({"bicut", "choopy", "attncut", "mtchoopy", "mtattncut",
                         "mmoecut", "moecut", "mtple", "probe_base"})

# Models whose forward returns a list of task heads, decoded from the LAST
# head (the cut tower); the reference keys this on `"m" in model_name`.
MULTI_HEAD = frozenset({"mtchoopy", "mtattncut", "mmoecut", "moecut", "mtple"})


# Per model, the parameters whose gradient is zero by algebra: a training
# step's gradient there is rounding noise, which a comparison of two runs
# holds to the model's largest gradient rather than to its own size.
_TOWER_BIASES = ("tower_rerank.linear.bias", "tower_cut.linear.bias")
ZERO_GRAD_LEAVES = {
    # the towers' biases under a softmax over positions (the cut tower) or
    # the rerank criterion
    "mmoecut": _TOWER_BIASES, "moecut": _TOWER_BIASES, "mtple": _TOWER_BIASES,
    # the encoder's last LayerNorm bias b shifts every position's logit by
    # decision.weight . b, which the softmax over positions cancels
    "attncut": ("decision.bias", "attention_layer.layers_0.norm2.bias"),
    # the rerank hinge's two batch means cancel the bias
    "mtattncut": ("heads.rerank.bias", "heads.decision.bias"),
    "bicut": (),
    # as AttnCut's: the last of the three encoder layers
    "choopy": ("decision.bias", "attention_layer.layers_2.norm2.bias"),
    # as MtAttnCut's
    "mtchoopy": ("heads.rerank.bias", "heads.decision.bias"),
}


def is_multi_head(name: str) -> bool:
    """True when `name`'s forward output is a list of heads."""
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model: {name!r}")
    return name in MULTI_HEAD


def build_model(name: str, *, seq_len: int, input_size: int, dropout,
                num_tasks: float = 3, seed: int = 0, members: int | None = None):
    """Model dispatch mirroring the JAX package's `build_model` (the same
    constructor arguments), with the initial weights drawn from `seed`;
    with `members=K`, the model of K members in one (its weights drawn
    once; `build_population_model` fills it), `dropout` one rate or K."""
    common = dict(dropout=dropout, seed=seed, members=members)
    if name == "bicut":
        return BiCut(input_size=input_size, **common)
    if name == "choopy":
        return Choopy(seq_len=seq_len, **common)
    if name == "attncut":
        return AttnCut(input_size=input_size, **common)
    if name == "mtchoopy":
        return MtChoopy(seq_len=seq_len, num_tasks=num_tasks, **common)
    if name == "mtattncut":
        return MtAttnCut(input_size=input_size, num_tasks=num_tasks, **common)
    if name in ("mmoecut", "moecut"):
        return MODELS[name](seq_len=seq_len, num_tasks=num_tasks,
                            input_size=input_size, **common)
    if name == "mtple":
        return PLECut(seq_len=seq_len, input_size=input_size, **common)
    if name == "probe_base":
        if members is not None:
            check_population_model(name)
        # the JAX package builds it with the default three tasks
        return ProbeBase(seq_len=seq_len, input_size=input_size, dropout=dropout,
                         num_experts=2, seed=seed)
    raise ValueError(f"unknown model: {name!r}")


# the models that train as a population, K members in one model: all eight
# (not probe_base: the JAX package has no criterion to train it with either)
POPULATION_MODELS = frozenset(MODELS)


def check_population_model(name: str) -> None:
    """Raise a ValueError unless `name` trains as a population."""
    if name not in POPULATION_MODELS:
        raise ValueError(f"population training takes {sorted(POPULATION_MODELS)}, not "
                         f"{name!r}: probe_base trains only through verify_probe, and the "
                         "JAX package has no criterion for it either (ROADMAP.md A4)")


def build_population_model(name: str, *, seq_len: int, input_size: int,
                           dropout, seeds, num_tasks: float = 3):
    """K models in one, member m initialised exactly as `build_model(...,
    seed=seeds[m], dropout=its rate)` and stacked on a leading member axis
    of every leaf. `dropout`: one rate for every member, or K rates."""
    check_population_model(name)
    seeds = list(seeds)
    if not seeds:
        raise ValueError("a population needs at least one member")
    rates = ([float(dropout)] * len(seeds) if isinstance(dropout, (int, float))
             else [float(r) for r in dropout])
    if len(rates) != len(seeds):
        raise ValueError(f"{len(rates)} dropout rates for {len(seeds)} members")
    kwargs = dict(seq_len=seq_len, input_size=input_size, num_tasks=num_tasks)
    model = build_model(name, members=len(seeds), dropout=rates, **kwargs)
    model.load_state_dict(stack_state_dicts(
        [build_model(name, seed=seed, dropout=rate, **kwargs).state_dict()
         for seed, rate in zip(seeds, rates)]))
    return model
