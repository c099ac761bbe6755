"""Host-side data helpers of the port: tokenizers, and the dataset, eval
transforms and loader behind ``retrieval.encode.encode_csv``. Importing any
of them loads no pandas, PIL or yaml (the functions that need pandas or PIL
import them): the card's path needs none of them."""
