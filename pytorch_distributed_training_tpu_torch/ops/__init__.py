"""Attention ops: plain full-sequence attention (``ops.attention``) and
the decode-attention kernels (``ops.decode_attention``; CUDA source in
``csrc/decode_attention.cu``) with their plain versions."""
