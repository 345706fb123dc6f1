"""v2 blocks, PQMF modules and the RAVE autoencoder."""
