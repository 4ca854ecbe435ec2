from yolo_ad_refine_tpu_torch.cfg.cli import entrypoint

if __name__ == "__main__":
    raise SystemExit(entrypoint())
