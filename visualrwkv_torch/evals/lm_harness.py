"""Text-LM evaluation: loglikelihood API + perplexity CLI. Counterpart of
``visualrwkv_tpu/evals/lm_harness.py``.

The reference adapts the text LM to lm-eval-harness (eval/run_lm_eval.py).
``lm_eval`` is an optional dependency, so this module provides:

- :class:`RWKVLoglikelihood` — the loglikelihood/greedy API surface that an
  lm-eval-harness adapter needs (and a thin ``make_lm_eval_adapter`` that
  registers it when lm_eval IS importable);
- a perplexity CLI over a text file, as the dependency-free regression signal.

Every call is one stateless forward (the chunked prefill) on the device the
parameters are on; logits go through ``log_softmax`` in fp32.

    python -m visualrwkv_torch.evals.lm_harness --model_path lm.pth --text_file t.txt
"""

from __future__ import annotations

import argparse
import math
from typing import List, Tuple

import torch

from visualrwkv_torch.config import RWKVConfig
from visualrwkv_torch.models import lm


def _forward_logits(params, cfg: RWKVConfig, ids: List[int]) -> torch.Tensor:
    """Logits ``[T, V]`` fp32 of one token sequence."""
    t = torch.as_tensor([ids], dtype=torch.long, device=params["emb"]["weight"].device)
    return lm.lm_forward_tokens(params, cfg, t)[0][0].float()


class RWKVLoglikelihood:
    def __init__(self, params, cfg: RWKVConfig, tokenizer):
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer

    @torch.no_grad()
    def loglikelihood_tokens(self, context: List[int], continuation: List[int]) -> Tuple[float, bool]:
        """(sum log p(continuation | context), is_greedy)."""
        logits = _forward_logits(self.params, self.cfg, context + continuation)
        # long, also when empty: an empty continuation scores (0.0, True)
        pos = torch.as_tensor([len(context) + j - 1 for j in range(len(continuation))],
                              dtype=torch.long, device=logits.device)
        tgt = torch.as_tensor(continuation, dtype=torch.long, device=logits.device)
        at = logits[pos]
        logp = torch.log_softmax(at, -1).gather(-1, tgt[:, None])[:, 0].cpu()
        greedy = bool((at.argmax(-1) == tgt).all())
        return sum((float(x) for x in logp), 0.0), greedy

    def loglikelihood(self, context: str, continuation: str) -> Tuple[float, bool]:
        ctx = self.tok.encode(context) if context else [0]
        cont = self.tok.encode(continuation)
        return self.loglikelihood_tokens(ctx, cont)


def make_lm_eval_adapter(params, cfg, tokenizer):
    """Returns an lm-eval-harness LM instance when lm_eval is importable."""
    try:
        from lm_eval.api.model import LM
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError("lm_eval is not installed") from e

    scorer = RWKVLoglikelihood(params, cfg, tokenizer)

    class VisualRWKVEvalLM(LM):
        def loglikelihood(self, requests):
            return [scorer.loglikelihood(r.args[0], r.args[1]) for r in requests]

        def loglikelihood_rolling(self, requests):
            out = []
            for r in requests:
                toks = tokenizer.encode(r.args[0])
                ll, _ = scorer.loglikelihood_tokens([0], toks)
                out.append((ll,))
            return out

        def generate_until(self, requests):
            raise NotImplementedError("use visualrwkv_torch.evals.runner for generation tasks")

    return VisualRWKVEvalLM()


@torch.no_grad()
def perplexity(params, cfg: RWKVConfig, tokenizer, text: str, stride: int = 1024) -> float:
    """exp(mean NLL) of ``text`` (after a leading token 0) over windows of
    ``stride`` + 1 tokens, each one stateless forward of ``stride`` tokens
    (the last window shorter)."""
    ids = [0] + tokenizer.encode(text)
    nll, count = 0.0, 0
    for start in range(0, len(ids) - 1, stride):
        chunk = ids[start : start + stride + 1]
        if len(chunk) < 2:
            break
        logits = _forward_logits(params, cfg, chunk[:-1])
        tgt = torch.as_tensor(chunk[1:], device=logits.device)
        logp = torch.log_softmax(logits, -1)
        nll -= float(logp.gather(-1, tgt[:, None]).sum())
        count += len(chunk) - 1
    return math.exp(nll / max(count, 1))


def main(argv=None):
    p = argparse.ArgumentParser("visualrwkv_torch.evals.lm_harness")
    p.add_argument("--model_path", default="", type=str)
    p.add_argument("--text_file", required=True, type=str)
    p.add_argument("--n_layer", default=12, type=int)
    p.add_argument("--n_embd", default=768, type=int)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from visualrwkv_torch.config import resolve_device
    from visualrwkv_torch.data.tokenizer import get_tokenizer
    from visualrwkv_torch.infer.strategy import place

    device = resolve_device(args.device)
    cfg = RWKVConfig(n_layer=args.n_layer, n_embd=args.n_embd)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = lm.init_lm_params(gen, cfg, device)
    if args.model_path:
        from visualrwkv_torch.convert.pth_import import import_rwkv_state_dict, load_pth

        params = place(import_rwkv_state_dict(load_pth(args.model_path)), device)
    with open(args.text_file) as f:
        text = f.read()
    ppl = perplexity(params, cfg, get_tokenizer(), text)
    print({"perplexity": round(ppl, 3), "chars": len(text)})
    return ppl


if __name__ == "__main__":
    main()
