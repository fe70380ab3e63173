"""Multimodal chat demo on the port's engine. Counterpart of
``visualrwkv_tpu/apps/demo.py`` (the reference's app/app_gpu.py,
app_cpu.py and app_merge.py).

An image is prefilled once into an RNN state (cached by a content hash),
each question decodes from that state with top-p sampling and presence /
count penalties, and a chat chains states. A gradio UI when gradio is
importable, else a terminal REPL. Runs on the card unless ``--device cpu``
or a ``cpu`` strategy asks for the CPU.

    python -m visualrwkv_torch.apps.demo --model_path m.pth --strategy "gpu bf16i8 s16"
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

CTX_LIMIT = 3500  # reference app_gpu.py:21
GEN_PROMPT = "\n{instruction}\n\nAssistant:"  # reference app_gpu.py:44-46


def generate_prompt(instruction: str, input: str = "") -> str:
    """The raw-generation prompt (reference app_merge.py:29-39): an
    Instruction / Input / Response form when an input is given, else a
    primed User / Assistant chat opening."""
    instruction = instruction.strip().replace("\r\n", "\n").replace("\n\n", "\n")
    input = input.strip().replace("\r\n", "\n").replace("\n\n", "\n")
    if input:
        return f"Instruction: {instruction}\nInput: {input}\nResponse:"
    return (
        "User: hi\n"
        "Assistant: Hi. I am your assistant and I will provide expert full "
        "response in full details. Please feel free to ask any question and "
        "I will always answer it.\n"
        f"User: {instruction}\nAssistant:"
    )


def text_fn(engine, tokenizer):
    """Raw generation with the LM alone (app_merge's 'Raw Generation' tab):
    no image, the reference's sampling defaults (temperature floor 0.2)."""

    def respond(prompt, max_new_tokens=333, temperature=1.0, top_p=0.3,
                presence_penalty=0.0, count_penalty=1.0):
        ids = np.asarray([tokenizer.encode(prompt.strip())[-CTX_LIMIT:]])
        res = engine.generate(
            ids, max_new_tokens=int(max_new_tokens), do_sample=True,
            temperature=max(0.2, float(temperature)), top_p=float(top_p),
            alpha_presence=presence_penalty, alpha_frequency=count_penalty,
        )
        return engine.decode_text(res, tokenizer)[0]

    return respond


def _device(args) -> str:
    """The device of ``--strategy`` when one is given (the flag is optional:
    the eval CLIs have none), else ``--device``."""
    if getattr(args, "strategy", ""):
        from visualrwkv_torch.infer.strategy import parse_strategy

        return parse_strategy(args.strategy).torch_device
    return args.device


def _engine(params, cfg, args):
    """The engine of ``--strategy``, else of ``--quant`` / ``--state_dtype`` /
    ``--state_layout``."""
    from visualrwkv_torch.infer.engine import InferenceEngine

    if getattr(args, "strategy", ""):  # a reference-style strategy string, e.g. "gpu bf16i8 s16"
        from visualrwkv_torch.infer.strategy import make_engine

        return make_engine(params, cfg, args.strategy)
    if args.quant == "int8":
        from visualrwkv_torch.infer.quant import quantize_lm_params

        params["rwkv"] = quantize_lm_params(params["rwkv"])
    return InferenceEngine(params, cfg, state_dtype=args.state_dtype, state_layout=args.state_layout,
                           device=args.device)


def build_engine(args):
    """(engine, config) of a VisualRWKV model: a seeded init of the
    configuration the flags give, with the LM of ``--model_path`` (a
    reference ``.pth``) in place of the random one."""
    from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig
    from visualrwkv_torch.infer.strategy import place
    from visualrwkv_torch.models.visualrwkv import init_visualrwkv_params

    cfg = VLMConfig(
        rwkv=RWKVConfig(n_layer=args.n_layer, n_embd=args.n_embd, ctx_len=args.ctx_len),
        vision=VisionConfig(towers=tuple(t for t in args.vision_towers.split(",") if t)),
        proj_type=args.proj_type,
        num_token_per_image=args.num_token_per_image,
    )
    device = _device(args)
    params = init_visualrwkv_params(cfg, seed=0, device=device)
    if args.model_path.endswith(".pth"):
        from visualrwkv_torch.convert.pth_import import import_rwkv_state_dict, load_pth

        params["rwkv"] = place(import_rwkv_state_dict(load_pth(args.model_path)), device)
    return _engine(params, cfg, args), cfg


def build_text_engine(args):
    """An engine of the bare text RWKV of ``--lm_model_path`` for the raw
    generation tab (app_merge.py's separate RWKV World model), its geometry
    read from the checkpoint."""
    from visualrwkv_torch.config import RWKVConfig, VisionConfig, VLMConfig
    from visualrwkv_torch.convert.pth_import import detect_rwkv_version, import_rwkv_state_dict, load_pth
    from visualrwkv_torch.infer.strategy import place

    sd = load_pth(args.lm_model_path)
    info = detect_rwkv_version(sd)
    cfg = VLMConfig(
        rwkv=RWKVConfig(n_layer=info["n_layer"], n_embd=info["n_embd"], vocab_size=info["vocab_size"],
                        head_size=info.get("head_size", 64), ctx_len=args.ctx_len,
                        version=info["version"]),
        vision=VisionConfig(towers=()),
    )
    params = {"rwkv": place(import_rwkv_state_dict(sd), _device(args))}
    return _engine(params, cfg, args)


def chat_fn(engine, tokenizer, cfg):
    """Image chat: the image's state (cached), then the question from it."""
    from visualrwkv_torch.data.dataset import load_image_uint8

    def respond(image_path, question, temperature=1.0, top_p=0.3,
                presence_penalty=0.0, count_penalty=1.0, max_new_tokens=200):
        states = None
        if image_path:
            sizes = {t: (cfg.vision.sam_image_size if t == "sam" else cfg.vision.image_size)
                     for t in cfg.vision.towers}
            images = {t: v[None] for t, v in load_image_uint8(image_path, sizes).items()}
            states = engine.compute_image_state(images)
        prompt = GEN_PROMPT.format(instruction=question.strip())
        ids = np.asarray([tokenizer.encode(prompt)[-CTX_LIMIT:]])
        res = engine.generate(
            ids, states=states, max_new_tokens=max_new_tokens, do_sample=True,
            temperature=max(0.2, temperature), top_p=top_p,
            alpha_presence=presence_penalty, alpha_frequency=count_penalty,
        )
        return engine.decode_text(res, tokenizer)[0]

    return respond


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """The engine flags the demo and the serving CLI share."""
    p.add_argument("--model_path", default="", type=str)
    p.add_argument("--n_layer", default=12, type=int)
    p.add_argument("--n_embd", default=768, type=int)
    p.add_argument("--ctx_len", default=2048, type=int)
    p.add_argument("--proj_type", default="mlp")
    p.add_argument("--num_token_per_image", default=1024, type=int)
    p.add_argument("--vision_towers", default="dino,siglip,sam")
    p.add_argument("--quant", default="none", choices=["none", "int8"])
    p.add_argument("--strategy", default="", type=str,
                   help="strategy string (overrides --quant / --state_dtype / --device), e.g. "
                   "'gpu bf16i8 s16'")
    p.add_argument("--state_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="decode WKV state carry dtype")
    p.add_argument("--state_layout", default="head", choices=["head", "flat"],
                   help="flat = the [B, 64, H*64] decode state")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("visualrwkv_torch.apps.demo")
    add_engine_args(p)
    p.add_argument("--share", action="store_true")
    p.add_argument("--lm_model_path", default="", type=str,
                   help="a separate bare text RWKV .pth for the raw generation tab (app_merge.py's "
                   "two tabs); its geometry is read from the checkpoint")
    args = p.parse_args(argv)

    from visualrwkv_torch.data.tokenizer import get_tokenizer

    engine, cfg = build_engine(args)
    tokenizer = get_tokenizer()
    respond = chat_fn(engine, tokenizer, cfg)
    # the raw tab serves a separate text checkpoint when given, else the VLM's own LM
    respond_text = text_fn(build_text_engine(args) if args.lm_model_path else engine, tokenizer)
    try:
        import gradio as gr
    except ImportError:
        gr = None
    if gr is not None:
        build_ui(gr, respond, respond_text).launch(share=args.share)
    else:
        run_repl(respond, respond_text)


def build_ui(gr, respond, respond_text):
    """Construct, without launching, the two-tab gradio Blocks app (the
    reference's app_merge.py layout); ``gr`` is the gradio module, passed in
    so that the UI can be built without gradio installed."""
    with gr.Blocks(title="VisualRWKV") as demo:
        gr.Markdown("## VisualRWKV — O(1)-state multimodal chat")
        with gr.Tab("Raw Generation"):
            with gr.Row():
                with gr.Column():
                    prompt = gr.Textbox(lines=2, label="Prompt",
                                        value=generate_prompt("Tell me about ravens."))
                    tok_count = gr.Slider(10, 333, value=333, step=10, label="Max Tokens")
                    t_temp = gr.Slider(0.2, 2.0, value=1.0, label="Temperature")
                    t_topp = gr.Slider(0.0, 1.0, value=0.3, label="Top P")
                    t_pres = gr.Slider(0.0, 1.0, value=0.0, label="Presence Penalty")
                    t_cnt = gr.Slider(0.0, 1.0, value=1.0, label="Count Penalty")
                with gr.Column():
                    t_out = gr.Textbox(label="Output", lines=5)
                    t_btn = gr.Button("Submit", variant="primary")
            t_btn.click(respond_text, [prompt, tok_count, t_temp, t_topp, t_pres, t_cnt], t_out)
        with gr.Tab("Visual RWKV"):
            with gr.Row():
                image = gr.Image(type="filepath", label="Image")
                with gr.Column():
                    question = gr.Textbox(label="Question")
                    temperature = gr.Slider(0.2, 2.0, value=1.0, label="Temperature")
                    top_p = gr.Slider(0.0, 1.0, value=0.3, label="Top-p")
                    presence = gr.Slider(0.0, 1.0, value=0.0, label="Presence penalty")
                    count = gr.Slider(0.0, 1.0, value=1.0, label="Count penalty")
                    out = gr.Textbox(label="Answer")
                    btn = gr.Button("Generate")
            btn.click(respond, [image, question, temperature, top_p, presence, count], out)
    return demo


def run_repl(respond, respond_text):
    """The terminal chat: 'image <path>' sets the image, 'text <prompt>'
    generates without one, any other line asks about the image."""
    print("gradio not available; terminal REPL. 'image <path>' sets the image; "
          "'text <prompt>' does raw (no-image) generation.")
    image_path = None
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        if line.startswith("image "):
            image_path = line[len("image "):].strip()
            print(f"[image set: {image_path}]")
            continue
        if line.startswith("text "):
            print(respond_text(generate_prompt(line[len("text "):])))
            continue
        print(respond(image_path, line))


if __name__ == "__main__":
    main()
