"""Chunked WKV6 recurrence of the RWKV6 time mix (``csrc/rwkv6_scan.cu``)."""
