"""Bytes a kernel must move, from shapes: each input byte read once and each
output byte written once.  What the
inputs need where it depends on the data (table entries a step looks up) is
left out, so a count is a floor and a roofline share from it a lower
bound."""
