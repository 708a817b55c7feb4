"""The port's lab tools: measurements on the card, run as modules
(``python -m latteclip_torch.tools.<tool>``); not part of the library."""
