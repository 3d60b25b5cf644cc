"""tiny_mp2v_dec_tpu — an MPEG-2 (ISO/IEC 13818-2) video decoder in JAX.

Architecture (see SURVEY.md §7): bit-serial entropy decode and all sequential
macroblock state run on the host (native C++ tokenizer with a Python golden
model), emitting dense per-picture tensors; IDCT, motion compensation and
reconstruction run on the GPU as XLA programs (one per GOP chunk or per
picture); pictures scale across cards via jax.sharding.
"""
from .golden.decoder import DecodedFrame, decode_stream as decode_stream_golden
from .headers import CHROMA_420, CHROMA_422, CHROMA_444, PCT_B, PCT_I, PCT_P
from .runtime.decoder import DecoderConfig, MP2VDecoder

__version__ = "0.1.0"

__all__ = [
    "MP2VDecoder", "DecoderConfig", "DecodedFrame", "decode_stream_golden",
    "CHROMA_420", "CHROMA_422", "CHROMA_444", "PCT_I", "PCT_P", "PCT_B",
]
