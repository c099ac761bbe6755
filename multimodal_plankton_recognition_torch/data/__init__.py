"""Host-side data helpers of the port: tokenizers, the dataset, eval and
oversize transforms and loader behind ``retrieval.encode.encode_csv``, and
the packed cache (``packed``). Importing any of them loads no pandas, PIL
or yaml (the functions that need pandas or PIL import them): the card's
path needs none of them."""
