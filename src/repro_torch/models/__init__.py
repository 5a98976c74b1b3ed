"""Models of the port: layers, decode attention, the paged KV cache and the
dense decoder (`model.Model`)."""
