"""Signal ops of the port: STFT, mel front end, and the envelope kernel."""
