"""Process context, env contract and reduction ops of the port."""
