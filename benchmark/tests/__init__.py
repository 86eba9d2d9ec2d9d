"""CPU tests of the port's benchmark (card tests skip without a card)."""
