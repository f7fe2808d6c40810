"""Inference entry point: decode bare audio files into sentences.

CLI surface parity with reference speech_recognition/run/inference.py.
"""

import argparse
import csv
import sys

from ..utils import get_logger, glob, open_file

# fmt: off
parser = argparse.ArgumentParser("This is script to inference (generate sentence) with a trained model")
parser.add_argument("--data-config", type=str, required=True, help="data processing config file")
parser.add_argument("--model-config", type=str, required=True, help="model config file")
parser.add_argument("--audio-files", required=True, help="an audio file or glob pattern of multiple files ex) *.pcm")
parser.add_argument("--model-path", type=str, required=True, help="pretrained model checkpoint")
parser.add_argument("--output-path", default="output.tsv", help="output tsv file path to save generated sentences")
parser.add_argument("--sp-model-path", type=str, required=True, help="sentencepiece model path")
parser.add_argument("--batch-size", type=int, default=512)
parser.add_argument("--beam-size", type=int, default=0, help="not given, use greedy search else beam search with this value as beam size")
parser.add_argument("--mixed-precision", action="store_true", help="Use mixed precision")
parser.add_argument("--device", type=str, default="CPU", choices=["CPU", "GPU"], help="device to run on")
parser.add_argument("--on-device-frontend", action=argparse.BooleanOptionalAction, help="compute audio features on device (default: on for GPU runs)")
# fmt: on


def main(args: argparse.Namespace):
    logger = get_logger("inference")

    from ..backend import select_device
    from .common import build_variables, compute_dtype, create_model

    select_device(args.device)

    import jax
    import numpy as np

    from ..configs import DataConfig, get_model_config
    from ..data import SentencePieceTokenizer, load_audio_file
    from ..models import LAS, Transducer
    from ..ops.features import delta_accelerate
    from ..search import DeepSpeechSearcher, LASSearcher, TransducerSearcher
    from ..train import restore_weights

    if args.mixed_precision:
        logger.info("[+] Use Mixed Precision (bfloat16)")

    with open_file(args.sp_model_path, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    bos_id, eos_id = tokenizer.tokenize("")

    dataset_files = sorted(glob(args.audio_files))
    if not dataset_files:
        logger.error("[Error] Dataset path is invalid!")
        sys.exit(1)

    logger.info(f"Load Data Config from {args.data_config}")
    config = DataConfig.from_yaml(args.data_config)

    from .common import frontend_decode_fn, use_raw_frontend

    raw_mode = use_raw_frontend(getattr(args, "on_device_frontend", None), args.device, False)

    # resample to the config rate, as the reference does (run/inference.py:59)
    load_fn = load_audio_file(config.sample_rate, config.file_format, config.sample_rate)
    feature_fn = config.make_audio_feature_fn("numpy")

    def stream():
        # decode (+ feature extraction unless the fused on-device frontend
        # handles it) in a thread pool, overlapping the device decode loop
        from ..data.dataset import parallel_map_stream

        def _one(path):
            audio = load_fn(path)
            if raw_mode:
                return audio
            feat = feature_fn(audio)
            if config.use_delta_accelerate:
                feat = delta_accelerate(feat)
            return feat

        return parallel_map_stream(dataset_files, _one)

    model_config = get_model_config(args.model_config)
    dtype = compute_dtype(args.mixed_precision, args.device)
    model = create_model(model_config, dtype)
    variables = build_variables(model, model_config, config, jax.random.PRNGKey(0))
    variables = dict(restore_weights(args.model_path, variables))
    logger.info(f"Loaded weights of model from {args.model_path}")

    if isinstance(model, LAS):
        searcher = LASSearcher(model, variables, config.max_token_length, bos_id, eos_id, model_config.pad_id)
    elif isinstance(model, Transducer):
        searcher = TransducerSearcher(
            model, variables, config.max_token_length, bos_id, eos_id, model_config.pad_index
        )
    else:
        # any CTC-family model (DeepSpeech2, Conformer): the searcher only
        # needs model.apply -> logits plus the blank index
        searcher = DeepSpeechSearcher(model, variables, model_config.blank_index)

    logger.info("Start Inference")
    from ..data.dataset import quantized_padded_batch

    # bounded shape set for the jitted decode loop (see run/evaluate.py)
    from .common import decode_pad_lengths

    audio_pad, _ = decode_pad_lengths(config, args.device)
    outputs = []
    from ..data.dataset import prefetch_stream

    # bf16 feature shipping under mixed precision (see run/evaluate.py)
    host_dtype = np.dtype(dtype) if args.mixed_precision else np.float32
    dummy_tokens = ((item, np.zeros(1, np.int32)) for item in stream())
    if raw_mode:
        logger.info("[+] Fused on-device audio frontend")
        from ..data.dataset import quantized_padded_raw_batch

        batches = prefetch_stream(
            quantized_padded_raw_batch(
                dummy_tokens, args.batch_size, config.frame_length, config.frame_step,
                max_frames=audio_pad,
            ),
            size=2,
        )
    else:
        batches = prefetch_stream(
            quantized_padded_batch(
                dummy_tokens,
                args.batch_size,
                audio_pad_length=audio_pad,
                audio_dtype=host_dtype,
            ),
            size=2,
        )
    if args.beam_size > 0:
        decode_fn = lambda audio: searcher.beam_search(audio, args.beam_size)[0][:, 0, :]
    else:
        decode_fn = lambda audio: searcher.greedy_search(audio)[0]
    if raw_mode:
        decode_fn = frontend_decode_fn(config, decode_fn)
    # multi-device: shard the batch rows over a data mesh (SPMD decode)
    from .common import sharded_decode_fn

    decode_fn, decode_mesh = sharded_decode_fn(decode_fn, args.batch_size)
    if decode_mesh is not None:
        logger.info(f"[+] SPMD decode over mesh {dict(zip(decode_mesh.axis_names, decode_mesh.devices.shape))}")
    # two decode calls in flight (see run/common.py pipelined_decode)
    from .common import timed_decode

    for decoded, _, n_valid in timed_decode(batches, decode_fn, config, raw_mode, logger):
        outputs.extend(decoded[:n_valid])

    sentences = [tokenizer.detokenize([int(t) for t in out]) for out in outputs]
    logger.info("Ended Inference, Start to save...")

    with open_file(args.output_path, "w") as fout:
        wtr = csv.writer(fout, delimiter="\t")
        wtr.writerow(["AudioPath", "DecodedSentence"])
        for audio_path, decoded_sentence in zip(dataset_files, sentences):
            wtr.writerow((audio_path, decoded_sentence))
    logger.info(f"Saved (audio path,decoded sentence) pairs to {args.output_path}")


if __name__ == "__main__":
    from ..backend import setup_compile_cache

    setup_compile_cache()
    sys.exit(main(parser.parse_args()))
