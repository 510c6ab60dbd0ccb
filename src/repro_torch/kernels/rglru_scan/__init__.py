"""RG-LRU linear recurrence over a sequence (``csrc/rglru_scan.cu``)."""
