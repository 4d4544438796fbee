"""Hyperparameter flattening for TensorBoard add_hparams.

Parity with utils/util.py:371-464: pull the tuning-relevant knobs out of
an experiment config into one flat dict.

A copy of mmt_tpu/utils/hparams.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import json
import os


def get_hparams_from_config(config):
  if isinstance(config, str):
    assert os.path.exists(config), f"The path {config} does not exist"
    with open(config) as f:
      config = json.load(f)
  if hasattr(config, "raw"):
    config = config.raw

  hparams = {"seed": config.get("seed", 0)}
  train_sets = config.get("train_sets", [])
  if not train_sets or "mix" not in train_sets[0].get("args", {}):
    return hparams

  mix = train_sets[0]["args"]["mix"]
  pretraining = (len(train_sets) > 1
                 and train_sets[0]["args"].get("until_epoch", 0) > 0)
  if pretraining:
    hparams["ptrn_epochs"] = train_sets[0]["args"]["until_epoch"]
    for entry in mix:
      hparams[f"weight_{entry['dataset_name']}"] = entry.get("mix_weight", 1)
  else:
    for entry in train_sets[-1]["args"]["mix"]:
      hparams[f"weight_{entry['dataset_name']}"] = 1
    hparams["ptrn_epochs"] = 0

  if "query_shuffling" in mix[0]:
    hparams["query_shuffling"] = mix[0]["query_shuffling"]
  for mod in config["experts"]["modalities"]:
    hparams[f"mod_{mod}"] = 1
  hparams["nb_mods"] = len(config["experts"]["modalities"])

  args = config["arch"]["args"]
  if args.get("vid_cont") == "bert":
    vb = args["vid_bert_params"]
    hparams.update({
        "vid/num_hidden_layers": vb["num_hidden_layers"],
        "vid/num_attention_heads": vb["num_attention_heads"],
        "vid/hidden_dropout": vb["hidden_dropout_prob"],
        "vid/attention_dropout": vb["attention_probs_dropout_prob"],
        "vid/max_position_embeddings": vb["max_position_embeddings"],
        "vid/pos_enc": args["pos_enc"],
        "vid/out_tok": args["out_tok"],
    })
  if args.get("txt_agg", "").startswith("bert") and "txt_bert_params" in args:
    tb = args["txt_bert_params"]
    hparams["txt/hidden_dropout"] = tb["hidden_dropout_prob"]
    hparams["txt/attention_dropout"] = tb["attention_probs_dropout_prob"]

  hparams["keep_missing_modalities"] = args["keep_missing_modalities"]
  hparams["remove_stop_words"] = bool(mix[0].get("remove_stop_words", False))

  for section in ("train_sets", "continuous_eval_sets", "final_eval_sets"):
    for entry in config.get(section, []):
      if entry["args"].get("n_pairs", 1) > 1:
        hparams["n_pairs"] = entry["args"]["n_pairs"]

  hparams["nb_modalities"] = len(config["experts"]["modalities"])
  for key in ("txt_inp", "txt_agg", "txt_pro", "txt_wgh", "vid_wgh",
              "vid_cont", "vid_inp"):
    hparams[key] = args.get(key)
  hparams["lr"] = config["optimizer"]["args"]["lr"]
  hparams["weight_decay"] = config["optimizer"]["args"].get("weight_decay", 0)
  if "gamma" in config.get("lr_scheduler", {}).get("args", {}):
    hparams["gamma"] = config["lr_scheduler"]["args"]["gamma"]
  hparams["epochs"] = config["trainer"]["epochs"]
  hparams["loss"] = config["loss"]["type"]
  if "margin" in config["loss"].get("args", {}):
    hparams["margin"] = config["loss"]["args"]["margin"]
  hparams["batch_size"] = train_sets[0]["args"]["batch_size"]
  hparams["max_samples_per_epoch"] = config["trainer"].get(
      "max_samples_per_epoch")
  hparams["max_text_words"] = mix[0].get("max_text_words")
  return hparams
