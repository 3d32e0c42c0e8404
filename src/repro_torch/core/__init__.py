"""Host builder, HPT, tensor index and walk of the port."""
