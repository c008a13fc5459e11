"""Mining (port of sskd_tpu/mining): the BM25 index so far."""
