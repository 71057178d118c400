"""Model code of the port: the dense decoder's layers and the paged decode."""
