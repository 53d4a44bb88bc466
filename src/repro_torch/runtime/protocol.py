"""Wire protocol of the FaaS runtime — a thin veneer over ``repro_torch.wire``.

Everything that used to be hand-rolled here (framing, sparse pytree
encoding, byte accounting) now lives in the shared codec layer
(DESIGN.md §10): ``dist.compression``, the simulator's cost model and
this runtime all encode and account through the SAME functions, so
simulated bytes == measured bytes by construction.

What remains runtime-specific is only vocabulary: the broker
(``runtime.broker``) plays the RabbitMQ/Redis role of MLLess; workers
exchange significance-filtered updates *indirectly* through it over
persistent per-worker connections (``repro_torch.wire.framing.Connection``),
one request/response round trip per message.  The broker never decodes
payloads — it is a dumb byte store with per-message byte accounting,
exactly like the KV store in the paper — only workers encode/decode.

Tensor payloads per leaf use the codec registry: ``dense`` raw bytes,
``sparse`` flat-index+value pairs (int64 indices above 2**31 elements),
``bitmap`` packed mask + values, ``auto`` picking the smallest; values
optionally quantized to fp16/bf16 with an fp32 error-feedback residual.
"""

from __future__ import annotations

from repro_torch.wire.codec import (  # noqa: F401
    decode_leaf,
    decode_tree,
    encode_leaf,
    encode_tree,
    encode_tree_parts,
    tree_keys,
    tree_nbytes,
)
from repro_torch.wire.framing import (  # noqa: F401
    MAX_MSG_BYTES,
    TRANSPORTS,
    Connection,
    Transport,
    make_transport,
    pack_parts,
    pipelined,
    recv_msg,
    request,
    send_msg,
    unpack_parts,
)

# the broker's unit of record: payload bytes a meta list accounts for
wire_bytes = tree_nbytes
