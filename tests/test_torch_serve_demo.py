"""``examples/serve_demo_torch.py`` on the CPU at ``reduced()``, one arch of
each family the port serves: it decodes greedy tokens in the vocabulary,
and its first token is the argmax of the prefill step over the same prompt
(for the VLM without its prefix, since decode has no prefix path; for the
MoE archs at capacity_factor E / k, where the prefill drops nothing, as
decode never does; for whisper over the same frames)."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_zoo import no_drop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import decoder  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = {
    "ssm": "mamba2-1.3b",
    "dense": "qwen1.5-0.5b",
    "moe": "deepseek-moe-16b",
    "hybrid": "jamba-v0.1-52b",
    "vlm": "internvl2-2b",
    "audio": "whisper-large-v3",
}
B, P, TOKENS, SEED = 2, 10, 6, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_demo():
    spec = importlib.util.spec_from_file_location("serve_demo_torch", ROOT / "examples" / "serve_demo_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serve_demo_runs_every_family(family, capsys):
    arch = FAMILIES[family]
    out = load_demo().main(["--arch", arch, "--device", "cpu", "--batch", str(B), "--prompt-len", str(P),
                            "--tokens", str(TOKENS), "--seed", str(SEED)])
    cfg = reduced(get_config(arch))
    assert out["family"] == cfg.family == family
    tokens = torch.tensor(out["tokens"])
    assert tokens.shape == (B, TOKENS) and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    assert "decoded" in capsys.readouterr().out
    # the demo's draws, in its order: the prompt, then a prefix or frames
    g = torch.Generator().manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P), generator=g)}
    if cfg.num_prefix_tokens:
        torch.randn(B, cfg.num_prefix_tokens, cfg.d_model, generator=g)
        assert len(out["prefix_next"]) == B
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model, generator=g) * 0.5
    params = decoder.init_params(cfg, seed=SEED, device="cpu", max_seq=256)
    first = make_prefill_step(no_drop(cfg))(params, batch)[:, -1].argmax(-1)
    assert first.tolist() == tokens[:, 0].tolist()
