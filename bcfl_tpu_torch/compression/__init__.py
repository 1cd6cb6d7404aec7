"""Update-exchange codecs (port of ``bcfl_tpu/compression``)."""

from bcfl_tpu_torch.compression.codecs import (  # noqa: F401
    KINDS,
    CompressionConfig,
    corrupt_payload,
    decode_tree,
    encode_tree,
    encode_tree_unfused,
    payload_nbytes,
    roundtrip,
    wire_format,
    zero_residual,
)
