"""Host-side data helpers of the port: tokenizers, the dataset, the eval,
oversize and random train transforms, the loader and its copy to the
card (``pipeline``), the packed cache (``packed``) and the synthetic
dataset (``synthetic``). Importing any of them loads no pandas, PIL or
yaml (the functions that need pandas or PIL import them): the card's
path needs none of them."""
