"""The experiment runner: configs, the convexity benchmark's pixel
pipeline, its handles and its eval/plot toolbox."""
