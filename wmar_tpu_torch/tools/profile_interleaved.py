#!/usr/bin/env python
"""Profile a window of decode steps of the interleaved Chameleon loop on the card.

    python -m wmar_tpu_torch.tools.profile_interleaved [--first_step 1040] [--steps 8] \\
        [--caches bf16,int8] [--json out.json]
    python -m wmar_tpu_torch.tools.profile_interleaved --t2i --first_step 1000 --caches packed,packed4
    python -m wmar_tpu_torch.tools.profile_interleaved --taming --first_step 200 --caches packed4

Builds CHAMELEON_7B at full width and depth (random weights from ``--seed``,
int8 linears, the synthetic vocabulary and tokenizer), runs
``sample_interleaved_fused`` with a 4096-slot cache and the watermark
``linear-rand-h=1-d=2.0-g=0.25`` (one prompt, one image, the whole budget of
1154 tokens, since the budget decides when an image may open), and puts one
``torch.profiler`` window around ``steps`` whole loop iterations (model
forward, the two draws, the state updates) starting at loop step
``first_step``, where the cache holds over 1000 tokens. The window opens and
closes at the entry of a forward, with a device synchronize on either side,
so nothing of the loop is changed. Prints, per step: the host-clock time,
the kernel launches, the device time, and the device time by kernel name.
The profiler slows the host, so the host-clock time here is above that of
an unprofiled run; the device time and the launch count are not affected.

With ``--t2i`` the window lies in the text-to-image sampler instead
(``wrapper.sample`` on the 8 prompts of ``chip_smoke.py``: 24 CFG rows over
1043 slots, temperature 0.9, top-p 0.9), where the ``packed`` and ``packed4``
caches are read by the chunked packed kernels.

With ``--taming`` the window lies in Taming-1.4B's sampler instead
(``TAMING_GPT_1_4B`` with random weights from ``--seed`` made grouped-int4,
so that every linear and the head take kernel #8; 32 classes, temperature
1.0, top-k 250, top-p 0.92, the same watermark; 257 slots), where the
``packed4`` cache takes kernel #1 and the ``packed`` one kernel #2.

It needs a CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

WATERMARK = "linear-rand-h=1-d=2.0-g=0.25"
TAMING_CLASSES = 32
TAMING_GEN = dict(temperature=1.0, top_k=250, top_p=0.92)  # configs/taming_generate.json
T2I_PROMPTS = ["a cat", "a red fox", "a bowl of soup", "a lighthouse", "a dog in snow", "two owls", "a tall ship",
               "an old bridge at night"]


def build_wrapper(device, seed: int):
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.generate import load_chameleon
    from wmar_tpu_torch.models import quantize_llama_params_int8

    wrapper = load_chameleon(SimpleNamespace(tiny=False, seed=seed), device)
    wrapper.llama_params = quantize_llama_params_int8(wrapper.llama_params, compute_dtype=torch.bfloat16)
    wrapper.set_watermarker(WatermarkSpec.from_string(WATERMARK, vocab_size=wrapper.get_total_vocab_size(),
                                                      spatial_dim=wrapper.codes_size))
    return wrapper


def build_taming_wrapper(device, seed: int):
    """Taming-1.4B with grouped-int4 weights (kernel #8) and the watermark."""
    from wmar_tpu_torch.core import WatermarkSpec
    from wmar_tpu_torch.models import TAMING_GPT_1_4B, TAMING_IMAGENET_F16, TamingARMM, init_gpt, init_taming_vqgan
    from wmar_tpu_torch.models.taming_gpt import quantize_gpt_params_int8

    gen = torch.Generator(device=device).manual_seed(seed)
    gpt = init_gpt(TAMING_GPT_1_4B, gen, dtype=torch.float32, device=device)
    with torch.no_grad():
        gpt.pos_emb.normal_(0.0, 0.02, generator=gen)
    quantize_gpt_params_int8(gpt, compute_dtype=torch.bfloat16, bits=4)
    vq = init_taming_vqgan(TAMING_IMAGENET_F16, gen, dtype=torch.bfloat16, device=device)
    wrapper = TamingARMM(gpt, vq, cache_dtype="packed4", device=device)
    wrapper.set_watermarker(WatermarkSpec.from_string(WATERMARK, vocab_size=wrapper.get_total_vocab_size(),
                                                      spatial_dim=wrapper.codes_size))
    return wrapper


def profile_window(wrapper, cache_dtype, first_step: int, steps: int, seed: int, top: int = 12,
                   t2i: bool = False, taming: bool = False) -> dict:
    """One whole run with the window around ``steps`` iterations from loop
    step ``first_step`` on (an image-token step at the defaults). Loop step
    ``s`` is forward call ``s + 2`` (call 1 is the prefill). ``t2i``: the
    text-to-image sampler on 8 prompts instead of the interleaved loop;
    ``taming``: Taming-1.4B's sampler on 32 classes."""
    from torch.profiler import ProfilerActivity, profile

    from wmar_tpu_torch.models import GenParams, taming_gpt
    from wmar_tpu_torch.models import chameleon as t2i_module
    from wmar_tpu_torch.models import chameleon_interleaved as il

    if t2i:
        il = t2i_module  # the module whose llama_forward the window hooks
    hooked, attr = (taming_gpt, "gpt_forward") if taming else (il, "llama_forward")

    wrapper.cache_dtype = cache_dtype
    device = wrapper.device
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    calls, clock = [0], {}
    real = getattr(hooked, attr)

    def forward(*args, **kwargs):
        calls[0] += 1
        if calls[0] == first_step + 2:
            torch.cuda.synchronize(device)
            prof.start()
            clock["t0"] = time.perf_counter()
        elif calls[0] == first_step + steps + 2:
            torch.cuda.synchronize(device)
            clock["t1"] = time.perf_counter()
            prof.stop()
        return real(*args, **kwargs)

    setattr(hooked, attr, forward)
    gen_params = GenParams(temperature=0.9, top_k=None, top_p=0.9)
    try:
        if taming:
            wrapper.sample(list(range(TAMING_CLASSES)), GenParams(**TAMING_GEN), apply_watermark=True,
                           generator=torch.Generator(device=device).manual_seed(seed))
        elif t2i:
            wrapper.sample(T2I_PROMPTS, gen_params, apply_watermark=True,
                           generator=torch.Generator(device=device).manual_seed(seed))
        else:
            il.sample_interleaved_fused(wrapper, "a cat", gen_params, max_images=1, apply_watermark=True,
                                        cache_budget=4096,
                                        generator=torch.Generator(device=device).manual_seed(seed))
    finally:
        setattr(hooked, attr, real)
    if "t1" not in clock:
        raise RuntimeError(f"the window never closed: {calls[0]} forwards")
    kernels = []
    for evt in prof.key_averages():
        device_us = getattr(evt, "self_device_time_total", None)
        if device_us is None:
            device_us = evt.self_cuda_time_total
        if device_us > 0 and str(evt.device_type).endswith("CUDA"):
            kernels.append((evt.key, evt.count, device_us))
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    kernels.sort(key=lambda k: -k[2])
    device_ms = sum(k[2] for k in kernels) / 1e3 / steps
    out = {"first_step": first_step, "steps": steps, "host_ms_per_step": (clock["t1"] - clock["t0"]) * 1e3 / steps,
           "launches_per_step": sum(k[1] for k in kernels) / steps, "device_ms_per_step": device_ms,
           "kernels": [{"name": k[0][:90], "calls_per_step": k[1] / steps, "device_ms_per_step": k[2] / 1e3 / steps}
                       for k in kernels[:top]]}
    print(f"cache {cache_dtype}: loop steps {first_step}..{first_step + steps - 1} (fill {first_step + 8} and up): "
          f"host {out['host_ms_per_step']:.2f} ms per step, {out['launches_per_step']:.0f} launches, device "
          f"{device_ms:.2f} ms ({100 * (1 - device_ms / out['host_ms_per_step']):.0f}% idle)")
    for k in out["kernels"]:
        print(f"  {k['device_ms_per_step']:8.3f} ms  {k['calls_per_step']:7.1f} calls  {k['name']}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--first_step", type=int, default=1040)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--caches", type=str, default="bf16,int8")
    p.add_argument("--t2i", action="store_true", help="the text-to-image sampler (24 CFG rows) instead")
    p.add_argument("--taming", action="store_true", help="Taming-1.4B's sampler (32 classes, int4 weights) instead")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", type=str, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_interleaved: no CUDA card visible", file=sys.stderr)
        return 1
    from wmar_tpu_torch.tools.bench_attention import card_line

    device = torch.device("cuda", 0)
    print(f"card: {card_line()}")
    wrapper = build_taming_wrapper(device, args.seed) if args.taming else build_wrapper(device, args.seed)
    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8, "packed": "packed", "packed4": "packed4"}
    out = {"card": card_line()}
    for name in args.caches.split(","):
        out[name] = profile_window(wrapper, dtypes[name], args.first_step, args.steps, args.seed, t2i=args.t2i,
                                   taming=args.taming)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
