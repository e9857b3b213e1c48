"""Communication of the port: process-group setup (``comm.init``), the
data-parallel collectives (``comm.collectives``) and the KV-cache codec
(``comm.compress``) that the quantized paged pool needs."""
