"""Host-side data helpers of the port. Importing this package loads no
pandas, PIL or yaml: the card's path needs none of them."""
