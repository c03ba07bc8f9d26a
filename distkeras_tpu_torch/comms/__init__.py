"""Wire helpers of the port: chunked zero-copy egress (``chunking``), the
seeded retry policy (``retry``), the raw leaf codec and the affine
quantization rule (``codec``). The lossy codecs are ROADMAP.md Queue A,
item 13."""
