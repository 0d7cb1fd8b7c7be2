"""Convert reference PyTorch checkpoints to the parameter-tree files
(flax msgpack) that the port's ``--modelpath`` / weight flags read
(PyTorch port of ``tools/convert_ckpt.py``, same kinds, flags and file
names; it runs on the host, no card needed).

    python -m wmar_tpu_torch.tools.convert_ckpt taming --ckpt net2net.ckpt --outdir ckpts/taming
    python -m wmar_tpu_torch.tools.convert_ckpt rar --ckpt rar_xl.bin --size rar_xl \\
        --vq maskgit-vqgan-imagenet-f16-256.bin --outdir ckpts/rar
    python -m wmar_tpu_torch.tools.convert_ckpt chameleon_llama --ckpt 'anole/consolidated.*.pth' \\
        --outdir ckpts/chameleon
    python -m wmar_tpu_torch.tools.convert_ckpt chameleon_vqgan --ckpt vqgan.ckpt --outdir ckpts/chameleon
    python -m wmar_tpu_torch.tools.convert_ckpt decoder_delta ...  # see --help

Outputs: ``gpt.msgpack``, ``vqgan.msgpack``, ``discriminator.msgpack`` and
``config.json`` (taming); ``{size}.msgpack`` and ``maskgit_vqgan.msgpack``
(rar, maskgit_vqgan); ``vqgan.msgpack`` (chameleon_vqgan);
``llama7b.msgpack`` (chameleon_llama, from a glob of tensor-parallel
shards); ``{part}_delta.msgpack`` (taming_delta, chameleon_delta,
maskgit_delta); ``wam.msgpack``, ``syncseal.msgpack``,
``moshi_lm.msgpack``, ``mimi.msgpack``, ``adm_unet.msgpack``,
``{name}.msgpack`` (compressai, diffusers_vae), ``encodec24k.msgpack`` and
``dac24k.msgpack``. The files are byte for byte the JAX tool's for the same
float32 source; a bfloat16 source converts to a bfloat16 tree (the JAX
tool's reader raises on it). ``--gpt_heads`` defaults to the cin
transformer's 16 (the JAX tool's 24 does not divide 1664) and must divide
``--gpt_embd``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import torch

KINDS = ("taming", "rar", "chameleon_vqgan", "maskgit_vqgan", "chameleon_llama", "wam", "syncseal", "moshi", "mimi",
         "adm", "compressai", "diffusers_vae", "encodec", "dac", "taming_delta", "chameleon_delta", "maskgit_delta")
DISCRIMINATOR_PREFIXES = ("first_stage_model.loss.discriminator.main.", "loss.discriminator.main.")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("kind", choices=KINDS)
    p.add_argument("--base", default=None, help="full tokenizer checkpoint the delta applies to "
                                                "(*_delta kinds; --ckpt is the delta .pth itself)")
    p.add_argument("--part", default="encoder", choices=["encoder", "decoder"],
                   help="which tokenizer submodule the delta patches")
    p.add_argument("--name", default=None, help="codec name for compressai/diffusers_vae "
                                                "(e.g. cheng2020-anchor-q=3, diffusers-sd-vae-ft-ema)")
    p.add_argument("--ckpt", required=True, help="the source file; a glob of shards for chameleon_llama")
    p.add_argument("--vq", default=None, help="tokenizer ckpt (rar mode)")
    p.add_argument("--size", default="rar_xl")
    p.add_argument("--outdir", required=True)
    p.add_argument("--gpt_layers", type=int, default=48)
    p.add_argument("--gpt_heads", type=int, default=16)
    p.add_argument("--gpt_embd", type=int, default=1664)
    p.add_argument("--gpt_block", type=int, default=512)
    return p


def _numpy(sd):
    """A state dict as numpy arrays (the codec converters take numpy)."""
    return {k: v.numpy() if isinstance(v, torch.Tensor) and v.dtype != torch.bfloat16 else v for k, v in sd.items()}


def _taming(args, sd, save) -> None:
    from wmar_tpu_torch import bridge
    from wmar_tpu_torch.finetune.gan import convert_taming_discriminator
    from wmar_tpu_torch.models import TAMING_IMAGENET_F16, GPTConfig
    from wmar_tpu_torch.utils import convert

    if args.gpt_embd % args.gpt_heads:
        raise SystemExit(f"--gpt_heads {args.gpt_heads} does not divide --gpt_embd {args.gpt_embd}")
    gpt_cfg = GPTConfig(vocab_size=sd["transformer.tok_emb.weight"].shape[0], block_size=args.gpt_block,
                        n_layer=args.gpt_layers, n_head=args.gpt_heads, n_embd=args.gpt_embd)
    save("gpt.msgpack", convert.convert_taming_gpt(sd, gpt_cfg))
    save("vqgan.msgpack", convert.convert_taming_vqgan(sd, TAMING_IMAGENET_F16, prefix="first_stage_model."))
    # the VQGAN checkpoint's trained PatchGAN discriminator, which the RCC GAN
    # branch starts from unless --disable_gan (the reference's VQLPIPSWithDiscriminator)
    for prefix in DISCRIMINATOR_PREFIXES:
        if any(k.startswith(prefix) for k in sd):
            disc = convert_taming_discriminator(sd, prefix)
            dtype = sd[prefix + "0.weight"].dtype
            layers = bridge.flax_tree(disc)["layers"]
            save("discriminator.msgpack", {"layers": [_cast(layers[str(i)], dtype) for i in range(len(layers))]})
            break
    with open(os.path.join(args.outdir, "config.json"), "w") as f:
        json.dump({"gpt": gpt_cfg.__dict__}, f)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _delta(args, sd, save) -> None:
    from wmar_tpu_torch.models import CHAMELEON_F16, MASKGIT_IMAGENET_F16, TAMING_IMAGENET_F16
    from wmar_tpu_torch.utils import convert

    if not args.base:
        raise SystemExit("--base <full tokenizer checkpoint> required for *_delta")
    base_sd = convert.load_torch_state_dict(args.base)
    stage = ""
    if args.kind == "maskgit_delta":
        def fn(s):
            return convert.convert_maskgit_vqgan(s, MASKGIT_IMAGENET_F16)
    elif args.kind == "chameleon_delta":
        def fn(s):
            return convert.convert_taming_vqgan(s, CHAMELEON_F16)
    else:
        stage = "first_stage_model." if any(k.startswith("first_stage_model.") for k in base_sd) else ""

        def fn(s):
            return convert.convert_taming_vqgan(s, TAMING_IMAGENET_F16, prefix=stage)
    save(f"{args.part}_delta.msgpack", convert.convert_vqgan_delta(base_sd, sd, args.part, fn, stage_prefix=stage))


def load_shards(pattern: str):
    """The state dicts of a glob of shards (sorted by name), or of one file."""
    paths = sorted(glob.glob(pattern)) if "*" in pattern else [pattern]
    if not paths:
        raise SystemExit(f"no shard matches {pattern!r}")
    from wmar_tpu_torch.utils.convert import load_torch_state_dict

    return [load_torch_state_dict(p) for p in paths]


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    from wmar_tpu_torch.models import CHAMELEON_7B, CHAMELEON_F16, MASKGIT_IMAGENET_F16, rar_config
    from wmar_tpu_torch.utils import convert
    from wmar_tpu_torch.utils.checkpoint import save_pytree

    os.makedirs(args.outdir, exist_ok=True)

    def save(name, tree):
        save_pytree(os.path.join(args.outdir, name), tree)

    if args.kind == "chameleon_llama":
        # the merge and the conversion pop what they take and the file is streamed,
        # so about one copy of the weights is held at a time
        merged = convert.merge_chameleon_shards(load_shards(args.ckpt))
        tree = convert.convert_chameleon_llama(merged, CHAMELEON_7B)
        del merged
        save("llama7b.msgpack", tree)
        print(f"wrote {args.outdir}")
        return
    sd = convert.load_torch_state_dict(args.ckpt)
    if args.kind == "taming":
        _taming(args, sd, save)
    elif args.kind == "rar":
        save(f"{args.size}.msgpack", convert.convert_rar(sd, rar_config(args.size)))
        if args.vq:
            vq_sd = convert.load_torch_state_dict(args.vq)
            save("maskgit_vqgan.msgpack", convert.convert_maskgit_vqgan(vq_sd, MASKGIT_IMAGENET_F16))
    elif args.kind == "maskgit_vqgan":
        save("maskgit_vqgan.msgpack", convert.convert_maskgit_vqgan(sd, MASKGIT_IMAGENET_F16))
    elif args.kind.endswith("_delta"):
        _delta(args, sd, save)
    elif args.kind == "chameleon_vqgan":
        save("vqgan.msgpack", convert.convert_taming_vqgan(sd, CHAMELEON_F16))
    elif args.kind == "wam":
        from wmar_tpu_torch.sync.wam_exact import convert_wam

        save("wam.msgpack", convert_wam(sd))
    elif args.kind == "syncseal":
        from wmar_tpu_torch.sync import syncseal_models as sm

        unet_prefix = "embedder.unet." if any(k.startswith("embedder.unet.") for k in sd) else "unet."
        cn_prefix = "extractor.convnext." if any(k.startswith("extractor.") for k in sd) else "convnext."
        save("syncseal.msgpack", {"unet": sm.convert_unet(sd, prefix=unet_prefix),
                                  "convnext": sm.convert_convnext(sd, prefix=cn_prefix,
                                                                  head_prefix=cn_prefix.replace("convnext.", "head."))})
    elif args.kind == "moshi":
        from wmar_tpu_torch.audio.lm import MOSHI_V01, convert_moshi_lm

        save("moshi_lm.msgpack", convert_moshi_lm(sd, MOSHI_V01))
    elif args.kind == "mimi":
        from wmar_tpu_torch.audio.mimi import MIMI_V0_1, convert_mimi

        save("mimi.msgpack", convert_mimi(sd, MIMI_V0_1))
    elif args.kind == "adm":
        from wmar_tpu_torch.augmentations.diffpure import GUIDED_DIFFUSION_256_UNCOND, convert_adm_unet

        save("adm_unet.msgpack", convert_adm_unet(sd, GUIDED_DIFFUSION_256_UNCOND))
    elif args.kind == "compressai":
        from wmar_tpu_torch.augmentations import compressai_models as cm

        if not args.name:
            raise SystemExit("--name required (e.g. cheng2020-anchor-q=3)")
        arch, _ = cm.parse_codec_name(args.name)
        save(args.name + ".msgpack", cm.convert_compressai(_numpy(sd), arch))
    elif args.kind == "diffusers_vae":
        from wmar_tpu_torch.augmentations.diffusers_vae import KLVAEConfig, convert_kl_vae

        if not args.name:
            raise SystemExit("--name required (e.g. diffusers-sd-vae-ft-ema)")
        save(args.name + ".msgpack", convert_kl_vae(_numpy(sd), KLVAEConfig.for_name(args.name)))
    elif args.kind == "encodec":
        from wmar_tpu_torch.audio.codecs import ENCODEC_24K, convert_encodec

        save("encodec24k.msgpack", convert_encodec(sd, ENCODEC_24K))
    elif args.kind == "dac":
        from wmar_tpu_torch.audio.codecs import DAC_24K, convert_dac

        save("dac24k.msgpack", convert_dac(sd, DAC_24K))
    print(f"wrote {args.outdir}")


if __name__ == "__main__":
    main()
