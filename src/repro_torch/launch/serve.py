"""Batched serving (``repro.launch.serve``): the continuous-batching
prefill + decode loop over ``LM.prefill`` / ``LM.decode_step``.

Slot-based continuous batching: a fixed decode batch of ``--slots``
sequences; a finished sequence releases its slot to the next queued
request. The loop keeps the reference's behaviour exactly, quirks
included (ROADMAP.md C): the loop stops at ``prompt_len + gen_len``
positions, so only the first ``slots`` requests finish, and an admitted
request is not prefilled.

    python -m repro_torch.launch.serve --arch xlstm-1.3b --device cpu \\
        --requests 8 --slots 4 --prompt-len 32 --gen-len 16
    python -m repro_torch.launch.serve --arch phi4-mini-3.8b --no-smoke \\
        --requests 8 --slots 4 --prompt-len 1024 --gen-len 32

``--smoke`` (the default) takes the arch's reduced config. Runs on
``--device`` (default ``cuda``; ``cpu`` only when asked for); parameters
are a seeded random init, as in the reference. Prints the result as JSON:
the reference's keys plus ``device``, ``kernel_launches`` (the kernel
launches of this run, ``kernels.build.LAUNCHES``) and, on the card,
``peak_memory_bytes``.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch

from repro_torch import device as device_lib
from repro_torch.configs import ARCH_NAMES, get_arch, get_smoke
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import build
from repro_torch.models.transformer import LM


def _clock(dev: torch.device) -> float:
    """Host time after the card has finished what was queued."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def serve(args) -> dict:
    dev = device_lib.resolve(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    lm = LM(cfg)
    params = lm.init(args.seed, dev)
    max_len = args.prompt_len + args.gen_len
    slots = args.slots
    cache = lm.init_cache(slots, max_len, dev)
    launches0 = collections.Counter(build.LAUNCHES)

    # request queue: synthetic prompts
    pipe = TokenPipeline(cfg.vocab_size, args.prompt_len, args.requests,
                         seed=args.seed)
    prompts = torch.from_numpy(pipe.next_batch(0)["tokens"])

    # -- admit the first `slots` requests with one batched prefill
    t0 = _clock(dev)
    first = prompts[:slots].to(dev)
    logits, cache = lm.prefill(params, cache, {"tokens": first})
    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    prefill_s = _clock(dev) - t0

    slot_req = list(range(slots))  # which request occupies each slot
    generated: dict[int, list[int]] = {i: [] for i in range(args.requests)}
    remaining: list[int] = list(range(slots, args.requests))
    done = 0
    decode_steps = 0
    t1 = _clock(dev)
    pos = args.prompt_len
    while done < args.requests and pos < max_len:
        logits, cache = lm.decode_step(params, cache,
                                       {"tokens": next_tok[:, None]}, pos)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        decode_steps += 1
        toks = next_tok.tolist()
        for s, r in enumerate(slot_req):
            if r is None:
                continue
            generated[r].append(int(toks[s]))
            if len(generated[r]) >= args.gen_len:
                done += 1
                # slot release + admission (cache row reuse); as in the
                # reference, the admitted request is not prefilled
                slot_req[s] = remaining.pop(0) if remaining else None
        pos += 1
    decode_s = _clock(dev) - t1

    total_new = sum(len(v) for v in generated.values())
    launches = collections.Counter(build.LAUNCHES)
    launches.subtract(launches0)
    result = {
        "arch": cfg.name,
        "requests": args.requests,
        "slots": slots,
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_steps": decode_steps,
        "new_tokens": total_new,
        "decode_tokens_per_s": total_new / max(decode_s, 1e-9),
        "prefill_tokens_per_s": slots * args.prompt_len / max(prefill_s, 1e-9),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "kernel_launches": {k: v for k, v in launches.items() if v},
    }
    if dev.type == "cuda":
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="xlstm-1.3b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=device_lib.DEFAULT,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    print(json.dumps(serve(args), indent=1))


if __name__ == "__main__":
    main()
