"""Communication-side codecs of the port.  So far only the KV-cache codec
(``comm.compress``) that the quantized paged pool needs."""
